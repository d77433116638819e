"""Tuner tests: BO core, model tuner, pipeline tuner (configs[4] shape)."""

import numpy as np
import pytest

import autompc_tpu as ampc
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.config import (
    ConfigurationSpace,
    UniformFloatHyperparameter,
)
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.evaluation import HoldoutModelEvaluator
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import ARXFactory, SINDy, SINDyFactory
from autompc_tpu.tuning import (
    BatchBayesOpt,
    ModelTuner,
    PipelineTuner,
    RandomForestSurrogate,
)


class TestRandomForest:
    def test_fits_simple_function(self):
        rng = np.random.default_rng(0)
        X = rng.uniform(0, 1, (200, 3))
        y = 3 * X[:, 0] + np.sin(6 * X[:, 1])
        rf = RandomForestSurrogate(rng=rng).fit(X, y)
        mu, sigma = rf.predict(X[:50])
        resid = np.abs(mu - y[:50])
        assert resid.mean() < 0.3
        assert (sigma >= 0).all()


class TestBatchBayesOpt:
    def _space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(UniformFloatHyperparameter("x", 0.0, 1.0, 0.5))
        cs.add_hyperparameter(UniformFloatHyperparameter("y", 0.0, 1.0, 0.5))
        return cs

    def test_minimizes_quadratic(self):
        space = self._space()
        rng = np.random.default_rng(1)
        bo = BatchBayesOpt(space, rng=rng, batch_size=8, n_candidates=300)

        def f(cfg):
            return (cfg["x"] - 0.3) ** 2 + (cfg["y"] - 0.7) ** 2

        for _ in range(8):
            batch = bo.ask()
            bo.tell(batch, [f(c) for c in batch])
        inc, cost = bo.incumbent
        assert cost < 0.01
        assert abs(inc["x"] - 0.3) < 0.15

    def test_handles_inf_costs(self):
        space = self._space()
        bo = BatchBayesOpt(space, rng=np.random.default_rng(2), batch_size=4)
        for _ in range(6):
            batch = bo.ask()
            costs = [
                float("inf") if c["x"] > 0.5 else (c["x"] - 0.25) ** 2
                for c in batch
            ]
            bo.tell(batch, costs)
        inc, cost = bo.incumbent
        assert np.isfinite(cost)
        assert inc["x"] <= 0.5

    def test_first_proposal_is_default(self):
        space = self._space()
        bo = BatchBayesOpt(space, rng=np.random.default_rng(3), batch_size=3)
        batch = bo.ask()
        assert batch[0]["x"] == 0.5 and batch[0]["y"] == 0.5


@pytest.fixture(scope="module")
def benchmark():
    return CartpoleSwingupBenchmark()


@pytest.fixture(scope="module")
def trajs(benchmark):
    return benchmark.gen_trajs(seed=42, n_trajs=40, traj_len=60)


class TestModelTuner:
    def test_tunes_and_selects(self, benchmark, trajs):
        rng = np.random.default_rng(5)
        evaluator = HoldoutModelEvaluator(
            system=benchmark.system, trajs=trajs, metric="rmse", rng=rng,
            holdout_prop=0.25,
        )
        tuner = ModelTuner(benchmark.system, evaluator, eval_batch=3)
        tuner.add_model_factory(ARXFactory(benchmark.system))
        tuner.add_model_factory(SINDyFactory(benchmark.system))
        model, result = tuner.run(rng, n_iters=6)
        assert model is not None
        assert len(result.costs) == 6
        assert result.inc_costs[-1] == min(result.costs)
        # incumbent cost monotone nonincreasing
        assert all(
            a >= b for a, b in zip(result.inc_costs, result.inc_costs[1:])
        )

    def test_union_space_structure(self, benchmark):
        tuner = ModelTuner(benchmark.system, None)
        tuner.add_model_factory(ARXFactory(benchmark.system))
        tuner.add_model_factory(SINDyFactory(benchmark.system))
        space = tuner._build_space()
        cfg = space.get_default_configuration()
        assert "model" in cfg
        cfg["model"] = "ARX"
        assert "_ARX:history" in cfg
        assert "_SINDy:method" not in cfg
        cfg["model"] = "SINDy"
        assert "_SINDy:method" in cfg
        assert "_ARX:history" not in cfg


class TestPipelineTuner:
    def test_small_pipeline_tune(self, benchmark, trajs):
        """End-to-end AutoML smoke run: SINDy + QuadCost + iLQR tuned
        against a SINDy surrogate, 4 iterations."""
        rng = np.random.default_rng(7)
        pipeline = Pipeline(
            benchmark.system,
            SINDyFactory(benchmark.system),
            QuadCostFactory(benchmark.system),
            IterativeLQRFactory(benchmark.system),
        )
        # Fix the SINDy subspace to a known-good config to keep shapes
        # small and runs fast.
        tuner = PipelineTuner(
            surrogate_mode="defaultcfg",
            surrogate_factory=SINDyFactory(benchmark.system),
            surrogate_split=0.5,
            eval_batch=2,
        )
        controller, result = tuner.run(
            pipeline, benchmark.task, trajs, n_iters=4, rng=rng,
        )
        assert controller is not None
        assert len(result.costs) == 4
        assert np.isfinite(result.inc_costs[-1]) or result.inc_costs[-1] == float("inf")
        assert result.inc_cfg is not None
        # surrogate trajectories recorded
        assert len(result.surr_trajs) == 4

    def test_pretrain_without_surrogate_raises(self, benchmark, trajs):
        """surrogate_mode="pretrain" with no run(surrogate=...) raises a
        clear error instead of the reference's UnboundLocalError
        (reference pipeline_tuner.py:116-150 leaves the branch
        unhandled)."""
        import pytest

        rng = np.random.default_rng(3)
        pipeline = Pipeline(
            benchmark.system,
            SINDyFactory(benchmark.system),
            QuadCostFactory(benchmark.system),
            IterativeLQRFactory(benchmark.system),
        )
        tuner = PipelineTuner(
            surrogate_mode="pretrain", surrogate_split=0.5, eval_batch=2
        )
        with pytest.raises(ValueError, match="pretrain"):
            tuner.run(pipeline, benchmark.task, trajs, n_iters=1, rng=rng)


class TestPipelineTunerFanout:
    def test_fanout_matches_sequential(self, benchmark, trajs):
        """The mesh fan-out fast path scores candidates identically to
        the sequential simulate-based objective."""
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        pipeline = Pipeline(
            benchmark.system,
            model,  # fixed model => fan-out eligible
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            IterativeLQRFactory(benchmark.system),
        )
        task = benchmark.task.copy()
        task.set_num_steps(40)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=4)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=4, use_fanout=True
        )
        rng1 = np.random.default_rng(3)
        rng2 = np.random.default_rng(3)
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=4, rng=rng1, surrogate=model
        )
        _, res_fan = fan.run(
            pipeline, task, trajs, n_iters=4, rng=rng2, surrogate=model
        )
        # Same seed => same proposed configs in round 1 => same costs.
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-6), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    def test_gauss_reg_sum_cost_fanout_matches_sequential(
        self, benchmark, trajs
    ):
        """SumCostFactory(QuadCostFactory + GaussRegFactory) candidates
        ride the fan-out via the batched solver's per-lane-weighted
        shared dense reg term (make_batched_ilqr_solver reg_matrix);
        the sequential objective builds the explicit SumCost through
        the generic cost-hessian path. Scores must agree — and the
        fan-out must actually engage (no fallback warning)."""
        import warnings

        from autompc_tpu.costs import GaussRegFactory, SumCostFactory
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        cost_factory = SumCostFactory(
            benchmark.system,
            [
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                GaussRegFactory(benchmark.system),
            ],
        )
        pipeline = Pipeline(
            benchmark.system,
            model,  # fixed model => fan-out eligible
            cost_factory,
            IterativeLQRFactory(benchmark.system, horizon=6),
        )
        task = benchmark.task.copy()
        task.set_num_steps(25)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        rng1 = np.random.default_rng(3)
        rng2 = np.random.default_rng(3)
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=4, rng=rng1, surrogate=model
        )
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # fallback warns => fail
            _, res_fan = fan.run(
                pipeline, task, trajs, n_iters=4, rng=rng2, surrogate=model
            )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-6), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    def test_joint_sindy_fanout_matches_sequential(self, benchmark, trajs):
        """JOINT tuning (model factory, not a fixed model): per-candidate
        SINDy training + cost + controller, fused on the fan-out path,
        must score candidates identically to the sequential
        train-per-candidate objective (the reference's flagship loop,
        autompc/tuning/pipeline_tuner.py:213-258)."""
        from autompc_tpu.sysid import SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                SINDyFactory(
                    benchmark.system,
                    method="lstsq", time_mode="discrete",
                    poly_basis="false", trig_basis="true", trig_freq=1,
                    trig_interaction="true",
                ),
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                IterativeLQRFactory(benchmark.system, horizon=6),
            )

        task = benchmark.task.copy()
        task.set_num_steps(25)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        rng1 = np.random.default_rng(3)
        rng2 = np.random.default_rng(3)
        _, res_seq = seq.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng1,
            surrogate=surrogate,
        )
        _, res_fan = fan.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng2,
            surrogate=surrogate,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-6), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    def test_joint_sindy_gauss_reg_fanout_matches_sequential(
        self, benchmark, trajs
    ):
        """JOINT SINDy tuning with a SumCostFactory(QuadCost + GaussReg)
        cost space: per-lane training AND the per-lane-weighted reg
        term fuse into one program; scores must match the sequential
        train-per-candidate objective."""
        import warnings

        from autompc_tpu.costs import GaussRegFactory, SumCostFactory
        from autompc_tpu.sysid import SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                SINDyFactory(
                    benchmark.system,
                    method="lstsq", time_mode="discrete",
                    poly_basis="false", trig_basis="true", trig_freq=1,
                    trig_interaction="true",
                ),
                SumCostFactory(
                    benchmark.system,
                    [
                        QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                        GaussRegFactory(benchmark.system),
                    ],
                ),
                IterativeLQRFactory(benchmark.system, horizon=6),
            )

        task = benchmark.task.copy()
        task.set_num_steps(20)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        rng1 = np.random.default_rng(5)
        rng2 = np.random.default_rng(5)
        _, res_seq = seq.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng1,
            surrogate=surrogate,
        )
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, res_fan = fan.run(
                make_pipeline(), task, trajs, n_iters=4, rng=rng2,
                surrogate=surrogate,
            )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-6), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    def test_joint_mlp_fanout_matches_sequential(self, benchmark, trajs):
        """Joint MLP tuning: per-lane masked max-width nets trained
        inside the fan-out program must score candidates like the
        sequential train-per-candidate objective (training parity is
        rel 1e-5 per tuning/bucketed.py; closed-loop costs compared at
        a looser tolerance for the amplification through 25 MPC
        steps)."""
        from autompc_tpu.sysid import MLPFactory, SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                MLPFactory(
                    benchmark.system,
                    n_hidden_layers="1", nonlintype="tanh",
                    n_train_iters=4, n_batch=32,
                ),
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                IterativeLQRFactory(benchmark.system, horizon=6),
            )

        task = benchmark.task.copy()
        task.set_num_steps(25)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        kind, reason = fan._fanout_kind(make_pipeline(), surrogate)
        assert kind == "joint_mlp", reason
        rng1 = np.random.default_rng(3)
        rng2 = np.random.default_rng(3)
        _, res_seq = seq.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng1,
            surrogate=surrogate,
        )
        _, res_fan = fan.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng2,
            surrogate=surrogate,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=2e-2, abs=1e-3), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    def test_joint_mlp_horizon_mask_matches_per_horizon(
        self, benchmark, trajs
    ):
        """fanout_horizon_mask: candidates with DIFFERENT controller
        horizons evaluate through one horizon-polymorphic program
        (compiled at the config space's upper bound) and must score
        exactly like the per-horizon-bucketed fan-outs (the padding is
        algebraically inert — tests/test_horizon_mask.py)."""
        from autompc_tpu.sysid import MLPFactory, SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                MLPFactory(
                    benchmark.system,
                    n_hidden_layers="1", nonlintype="tanh",
                    n_train_iters=4, n_batch=32,
                ),
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                IterativeLQRFactory(benchmark.system),  # horizon TUNED
            )

        task = benchmark.task.copy()
        task.set_num_steps(25)

        per_h = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=3, use_fanout=True,
            fanout_horizon_mask=False,
        )
        masked = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=3, use_fanout=True,
            fanout_horizon_mask=True,
        )
        rng1 = np.random.default_rng(9)
        rng2 = np.random.default_rng(9)
        _, res_ph = per_h.run(
            make_pipeline(), task, trajs, n_iters=6, rng=rng1,
            surrogate=surrogate,
        )
        _, res_hm = masked.run(
            make_pipeline(), task, trajs, n_iters=6, rng=rng2,
            surrogate=surrogate,
        )
        # Same BO trajectory => same candidates; the masked program
        # must reproduce the per-horizon costs (x64 CPU: tight).
        for cs, cf in zip(res_ph.costs, res_hm.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-8), (
                    res_ph.costs, res_hm.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    def test_joint_koopman_lasso_fanout_matches_sequential(
        self, benchmark, trajs
    ):
        """Joint Koopman(method=lasso): per-lane FISTA-trained (A, B)
        operators + lifted-state iLQR, fused, vs the sequential
        train-per-candidate objective."""
        from autompc_tpu.sysid import KoopmanFactory, SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                KoopmanFactory(
                    benchmark.system,
                    method="lasso", poly_basis="false",
                    trig_basis="true", trig_freq=1,
                ),
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                IterativeLQRFactory(benchmark.system, horizon=6),
            )

        task = benchmark.task.copy()
        task.set_num_steps(20)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        kind, reason = fan._fanout_kind(make_pipeline(), surrogate)
        assert kind == "joint_koopman", reason
        rng1 = np.random.default_rng(5)
        rng2 = np.random.default_rng(5)
        _, res_seq = seq.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng1,
            surrogate=surrogate,
        )
        _, res_fan = fan.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng2,
            surrogate=surrogate,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-5, abs=1e-5), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    def test_joint_arx_fanout_runs(self, benchmark, trajs):
        """Joint ARX tuning: history buckets train one shared model and
        ride the fixed-model fan-out; costs are finite and the history
        hyperparameter reaches the bucket key."""
        pipeline = Pipeline(
            benchmark.system,
            ARXFactory(benchmark.system),
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            IterativeLQRFactory(benchmark.system, horizon=5),
        )
        from autompc_tpu.sysid import SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)
        task = benchmark.task.copy()
        task.set_num_steps(15)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        kind, reason = fan._fanout_kind(pipeline, surrogate)
        assert kind == "joint_arx", reason
        _, res = fan.run(
            pipeline, task, trajs, n_iters=2,
            rng=np.random.default_rng(0), surrogate=surrogate,
        )
        assert len(res.costs) == 2

    @pytest.mark.slow
    def test_joint_gp_fanout_matches_sequential(self, benchmark, trajs):
        """JOINT tuning with ApproximateGP candidates: the GP's only
        hyperparameter (induce_count) is shape-changing, so each bucket
        trains ONE shared SVGP (same data + same seed as the
        reference's per-candidate training, pipeline_tuner.py:213-258)
        and rides the fixed-model fan-out — scores must match the
        sequential train-per-candidate objective."""
        from autompc_tpu.sysid import SINDy
        from autompc_tpu.sysid.gp import ApproximateGPModelFactory

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)

        def make_pipeline():
            return Pipeline(
                benchmark.system,
                ApproximateGPModelFactory(
                    benchmark.system, niter=2, batch_size=256,
                ),
                QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                IterativeLQRFactory(benchmark.system, horizon=5),
            )

        task = benchmark.task.copy()
        task.set_num_steps(12)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        kind, reason = fan._fanout_kind(make_pipeline(), surrogate)
        assert kind == "joint_gp", reason
        rng1 = np.random.default_rng(7)
        rng2 = np.random.default_rng(7)
        _, res_seq = seq.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng1,
            surrogate=surrogate,
        )
        _, res_fan = fan.run(
            make_pipeline(), task, trajs, n_iters=4, rng=rng2,
            surrogate=surrogate,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-6, abs=1e-6), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    def test_fanout_fallback_warns_with_reason(self, benchmark, trajs):
        """use_fanout=True with an uncovered pipeline warns instead of
        silently degrading to the sequential path. GaussRegFactory
        alone is covered (the batched solver's reg term), so the
        uncovered layout here is a
        SumCostFactory of TWO QuadCostFactories — outside
        _cost_fanout_spec's at-most-one-of-each contract."""
        from autompc_tpu.costs import GaussRegFactory, SumCostFactory
        from autompc_tpu.sysid import SINDy

        surrogate = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        surrogate.train(trajs)
        model = surrogate
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=1, use_fanout=True
        )

        # GaussRegFactory alone: now eligible (reg term, zero diags).
        reg_pipeline = Pipeline(
            benchmark.system,
            model,
            GaussRegFactory(benchmark.system),
            IterativeLQRFactory(benchmark.system, horizon=5),
        )
        kind, reason = fan._fanout_kind(reg_pipeline, surrogate)
        assert kind == "ilqr", reason

        pipeline = Pipeline(
            benchmark.system,
            model,
            SumCostFactory(
                benchmark.system,
                [
                    QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                    QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                ],
            ),
            IterativeLQRFactory(benchmark.system, horizon=5),
        )
        task = benchmark.task.copy()
        task.set_num_steps(10)
        kind, reason = fan._fanout_kind(pipeline, surrogate)
        assert kind is None
        assert "QuadCostFactory" in reason
        with pytest.warns(UserWarning, match="no fan-out fast path"):
            fan.run(
                pipeline, task, trajs, n_iters=1,
                rng=np.random.default_rng(0), surrogate=surrogate,
            )

    def test_mppi_fanout_matches_sequential(self, benchmark, trajs):
        """MPPI-backed pipelines take the fan-out fast path and score
        candidates identically to the sequential objective (same PRNG
        stream, same metric)."""
        from autompc_tpu.control import MPPIFactory
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        pipeline = Pipeline(
            benchmark.system,
            model,
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            MPPIFactory(benchmark.system, num_path=64),
        )
        task = benchmark.task.copy()
        task.set_num_steps(25)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=3)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=3, use_fanout=True
        )
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(4), surrogate=model,
        )
        _, res_fan = fan.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(4), surrogate=model,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-5, abs=1e-5), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    @pytest.mark.slow
    @pytest.mark.parametrize("ctrl", ["mppi", "dt"])
    def test_gauss_reg_mppi_dt_fanout_matches_sequential(
        self, benchmark, trajs, ctrl
    ):
        """MPPI and DT fan-outs cover SumCostFactory(Quad + GaussReg)
        candidates by building the per-lane SumCost inside the vmap;
        scores must match the sequential objective and the fan-out must
        engage (no fallback warning)."""
        import warnings

        from autompc_tpu.control import (
            DirectTranscriptionControllerFactory,
            MPPIFactory,
        )
        from autompc_tpu.costs import GaussRegFactory, SumCostFactory
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        if ctrl == "mppi":
            cf = MPPIFactory(benchmark.system, num_path=64)
        else:
            cf = DirectTranscriptionControllerFactory(
                benchmark.system, horizon=0.25
            )
        pipeline = Pipeline(
            benchmark.system,
            model,
            SumCostFactory(
                benchmark.system,
                [
                    QuadCostFactory(benchmark.system, goal=np.zeros(4)),
                    GaussRegFactory(benchmark.system),
                ],
            ),
            cf,
        )
        task = benchmark.task.copy()
        task.set_num_steps(15)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=2, use_fanout=True
        )
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=2,
            rng=np.random.default_rng(6), surrogate=model,
        )
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, res_fan = fan.run(
                pipeline, task, trajs, n_iters=2,
                rng=np.random.default_rng(6), surrogate=model,
            )
        for cs, cf_ in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf_):
                assert cf_ == pytest.approx(cs, rel=1e-5, abs=1e-5), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf_)

    def test_dt_fanout_matches_sequential(self, benchmark, trajs):
        """Direct-transcription pipelines take the fan-out fast path;
        the factory's fixed horizon (seconds) buckets by knot count."""
        from autompc_tpu.control import DirectTranscriptionControllerFactory
        from autompc_tpu.sysid import SINDy

        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        pipeline = Pipeline(
            benchmark.system,
            model,
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            # 0.5 s @ dt=0.05 => 10 knots; kwargs override the cfg value
            # exactly like ControllerFactory.__call__.
            DirectTranscriptionControllerFactory(
                benchmark.system, horizon=0.5
            ),
        )
        task = benchmark.task.copy()
        task.set_num_steps(25)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=3)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=3, use_fanout=True
        )
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(5), surrogate=model,
        )
        _, res_fan = fan.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(5), surrogate=model,
        )
        for cs, cf in zip(res_seq.costs, res_fan.costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-5, abs=1e-5), (
                    res_seq.costs, res_fan.costs,
                )
            else:
                assert np.isinf(cs) == np.isinf(cf)

    def test_fanout_truedyn_reporting_matches_sequential(self, benchmark,
                                                         trajs):
        """With truedyn given, the fan-out path reports per-candidate
        true-dynamics costs (through the FunctionModel oracle fan-out)
        matching the sequential objective's."""
        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        pipeline = Pipeline(
            benchmark.system,
            model,
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            IterativeLQRFactory(benchmark.system),
        )
        task = benchmark.task.copy()
        task.set_num_steps(30)

        seq = PipelineTuner(surrogate_mode="pretrain", eval_batch=3)
        fan = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=3, use_fanout=True
        )
        _, res_seq = seq.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(6), surrogate=model,
            truedyn=benchmark.dynamics,
        )
        _, res_fan = fan.run(
            pipeline, task, trajs, n_iters=3,
            rng=np.random.default_rng(6), surrogate=model,
            truedyn=benchmark.dynamics,
        )
        assert len(res_fan.truedyn_costs) == 3
        for cs, cf in zip(res_seq.truedyn_costs, res_fan.truedyn_costs):
            if np.isfinite(cs) and np.isfinite(cf):
                assert cf == pytest.approx(cs, rel=1e-5, abs=1e-5)
            else:
                assert np.isinf(cs) == np.isinf(cf)
