"""Checkpoint/resume, pendulum benchmark, and metric tests."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import autompc_tpu as ampc
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark, PendulumSwingupBenchmark
from autompc_tpu.config import ConfigurationSpace, UniformFloatHyperparameter
from autompc_tpu.evaluation import get_model_rmse, get_model_rmsmens
from autompc_tpu.sysid import ARX
from autompc_tpu.tuning import BatchBayesOpt
from autompc_tpu.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def benchmark():
    return CartpoleSwingupBenchmark()


@pytest.fixture(scope="module")
def trajs(benchmark):
    return benchmark.gen_trajs_batch(seed=42, n_trajs=20, traj_len=50)


class TestCheckpoint:
    def test_model_roundtrip(self, benchmark, trajs, tmp_path):
        model = ARX(benchmark.system, history=3)
        model.train(trajs)
        path = str(tmp_path / "arx.ckpt")
        ckpt.save_model(path, model)
        model2 = ARX(benchmark.system, history=3)
        ckpt.restore_model(path, model2)
        s = model.traj_to_state(trajs[0][:10])
        u = jnp.ones(1)
        np.testing.assert_allclose(
            np.asarray(model.pred(s, u)), np.asarray(model2.pred(s, u))
        )

    def test_restore_class_mismatch(self, benchmark, trajs, tmp_path):
        model = ARX(benchmark.system, history=2)
        model.train(trajs)
        path = str(tmp_path / "arx.ckpt")
        ckpt.save_model(path, model)
        from autompc_tpu.sysid import SINDy

        other = SINDy(benchmark.system, method="lstsq")
        with pytest.raises(ValueError):
            ckpt.restore_model(path, other)

    def test_bo_state_roundtrip(self, tmp_path):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(UniformFloatHyperparameter("x", 0.0, 1.0, 0.5))
        rng = np.random.default_rng(0)
        bo = BatchBayesOpt(cs, rng=rng, batch_size=4)
        batch = bo.ask()
        bo.tell(batch, [c["x"] ** 2 for c in batch])
        state = ckpt.bo_state_dict(bo)
        path = str(tmp_path / "bo.ckpt")
        ckpt.save_checkpoint(path, state)

        bo2 = BatchBayesOpt(cs, rng=np.random.default_rng(1), batch_size=4)
        ckpt.bo_load_state(bo2, ckpt.load_checkpoint(path))
        assert len(bo2._y) == len(bo._y)
        inc1, c1 = bo.incumbent
        inc2, c2 = bo2.incumbent
        assert c1 == c2
        assert inc1["x"] == pytest.approx(inc2["x"])

    def test_atomic_write(self, tmp_path):
        path = str(tmp_path / "x.ckpt")
        ckpt.save_checkpoint(path, {"a": np.arange(3)})
        ckpt.save_checkpoint(path, {"a": np.arange(5)})
        out = ckpt.load_checkpoint(path)
        assert out["a"].shape == (5,)
        # no stray temp files
        assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


class TestPendulum:
    def test_spec_and_data(self):
        b = PendulumSwingupBenchmark()
        assert b.system.obs_dim == 2 and b.system.ctrl_dim == 1
        tb = b.gen_trajs_batch(seed=0, n_trajs=4, traj_len=30)
        assert np.isfinite(np.asarray(tb.obs)).all()
        ctrls = np.asarray(tb.ctrls)
        assert (np.abs(ctrls) <= 2.0 + 1e-9).all()

    def test_dynamics_consistency(self):
        b = PendulumSwingupBenchmark()
        tb = b.gen_trajs_batch(seed=1, n_trajs=1, traj_len=10)
        obs, ctrls = np.asarray(tb.obs), np.asarray(tb.ctrls)
        nxt = np.asarray(b.dynamics(jnp.asarray(obs[0, 0]), jnp.asarray(ctrls[0, 0])))
        np.testing.assert_allclose(obs[0, 1], nxt, rtol=1e-6)


class TestMetrics:
    def test_rmse_zero_for_perfect_model(self, benchmark, trajs):
        from autompc_tpu.sysid.dummy import FunctionModel

        model = FunctionModel(benchmark.system, benchmark.dynamics)
        rmse = get_model_rmse(model, trajs.to_list()[:3], horizon=3)
        assert rmse < 1e-6

    def test_rmse_increases_with_horizon(self, benchmark, trajs):
        model = ARX(benchmark.system, history=3)
        model.train(trajs)
        tl = trajs.to_list()[:3]
        r1 = get_model_rmse(model, tl, horizon=1)
        r5 = get_model_rmse(model, tl, horizon=5)
        assert r5 > r1

    def test_rmsmens_runs(self, benchmark, trajs):
        model = ARX(benchmark.system, history=2)
        model.train(trajs)
        val = get_model_rmsmens(model, trajs.to_list()[:3], horizon=2)
        assert np.isfinite(val) and val >= 0

    def test_batched_rmse_matches_listwise(self, benchmark, trajs):
        from autompc_tpu.evaluation import get_model_rmse_batch
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", trig_basis=True,
            time_mode="discrete",
        )
        model.train(trajs)
        tl = trajs.to_list()
        listwise = get_model_rmse(model, tl, horizon=2)
        batched = float(get_model_rmse_batch(model, trajs, horizon=2))
        assert batched == pytest.approx(listwise, rel=1e-5)


class TestPipelineTunerCheckpoint:
    def test_resume(self, benchmark, tmp_path):
        from autompc_tpu.control import IterativeLQRFactory
        from autompc_tpu.costs import QuadCostFactory
        from autompc_tpu.pipeline import Pipeline
        from autompc_tpu.sysid import ARXFactory
        from autompc_tpu.tuning import PipelineTuner

        trajs = benchmark.gen_trajs(seed=3, n_trajs=20, traj_len=40)
        pipeline = Pipeline(
            benchmark.system,
            ARXFactory(benchmark.system),
            QuadCostFactory(benchmark.system),
            IterativeLQRFactory(benchmark.system),
        )
        path = str(tmp_path / "tune.ckpt")
        tuner = PipelineTuner(
            surrogate_mode="defaultcfg",
            surrogate_factory=ARXFactory(benchmark.system),
            surrogate_split=0.5,
            eval_batch=2,
        )
        rng = np.random.default_rng(11)
        _, res1 = tuner.run(
            pipeline, benchmark.task, trajs, n_iters=2, rng=rng,
            checkpoint_path=path,
        )
        assert os.path.exists(path)
        # Resume: ask for 4 total; only 2 more evaluated.
        rng2 = np.random.default_rng(12)
        _, res2 = tuner.run(
            pipeline, benchmark.task, trajs, n_iters=4, rng=rng2,
            checkpoint_path=path,
        )
        assert len(res2.costs) == 4
        assert res2.costs[:2] == res1.costs


class TestCachedTuneAsset:
    def test_loadable_and_sane(self):
        from autompc_tpu.benchmarks import CartpoleSwingupV2Benchmark

        b = CartpoleSwingupV2Benchmark()
        result = b.get_cached_tune_result()
        assert result["kind"] == "pipeline_tune_result"
        assert len(result["costs"]) == len(result["cfg_dicts"])
        # The shipped tune found a genuinely good config on the box
        # metric (<=200 saturation; incumbent well below).
        assert min(result["inc_costs"]) < 100.0
        assert "_ctrlr:horizon" in result["inc_cfg"]


def test_fanout_regw_missing_raises_at_call_boundary():
    """A fan-out built with reg_matrix must reject a
    batch missing 'regw' with a labeled ValueError at the call
    boundary, not a raw KeyError from inside jit tracing."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.parallel.fanout import QuadCostFanout
    from autompc_tpu.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=0, n_trajs=5, traj_len=20)
    model = SINDy(
        b.system, method="lstsq", threshold=1e-3, trig_basis=True,
        trig_freq=1, trig_interaction=True, time_mode="discrete",
    )
    model.train(trajs)
    fan = QuadCostFanout(
        b.system, b.task, model, model, horizon=4, n_steps=3,
        goal=np.zeros(4), reg_matrix=np.eye(4),
    )
    batch = {
        "Qdiag": jnp.ones((2, 4)),
        "Fdiag": jnp.ones((2, 4)),
        "Rdiag": jnp.ones((2, 1)),
    }
    with pytest.raises(ValueError, match="regw"):
        fan(batch)
    with pytest.raises(ValueError, match="regw"):
        fan(dict(batch, regw=jnp.ones((3,))))
    # Correct batch runs.
    out = fan(dict(batch, regw=jnp.ones(2)))
    assert out.shape == (2,)


def test_sindy_gram_nan_falls_back_to_svd(monkeypatch, capsys):
    """A non-finite Gram-staged STLSQ result in the
    standalone SINDy trainer falls back to the SVD path instead of
    silently storing an all-zero model."""
    import jax.numpy as jnp
    import numpy as np

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu import sysid
    from autompc_tpu.ops import lstsq as lstsq_mod
    from autompc_tpu.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=1, n_trajs=5, traj_len=20)

    def bad_gram(G, bvec, threshold, **kw):
        return jnp.full((G.shape[0], bvec.shape[1]), jnp.nan)

    monkeypatch.setattr(lstsq_mod, "stlsq_gram", bad_gram)
    model = SINDy(
        b.system, method="lstsq", threshold=1e-3, trig_basis=True,
        trig_freq=1, trig_interaction=True, time_mode="discrete",
    )
    model.train(trajs)
    assert np.all(np.isfinite(np.asarray(model.coeffs)))
    assert np.any(np.asarray(model.coeffs) != 0)
    assert "falling back" in capsys.readouterr().out
