"""SINDy + iLQR tests (BASELINE.json configs[1]): model recovery on known
dynamics, solver correctness against an independent numpy iLQR, and the
cartpole swing-up closed loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import autompc_tpu as ampc
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import IterativeLQR, IterativeLQRFactory
from autompc_tpu.costs import QuadCost
from autompc_tpu.sysid import SINDy, SINDyFactory
from autompc_tpu.sysid.basis import FeatureLibrary, finite_difference
from autompc_tpu.utils import simulate


@pytest.fixture(scope="module")
def benchmark():
    return CartpoleSwingupBenchmark()


@pytest.fixture(scope="module")
def trajs(benchmark):
    return benchmark.gen_trajs_batch(seed=42, n_trajs=100, traj_len=100)


class TestFeatureLibrary:
    def test_identity_only(self):
        lib = FeatureLibrary.from_config(3)
        assert lib.n_features == 3
        z = jnp.array([1.0, 2.0, 3.0])
        np.testing.assert_allclose(np.asarray(lib(z)), [1.0, 2.0, 3.0])

    def test_trig(self):
        lib = FeatureLibrary.from_config(2, trig_basis=True, trig_freq=2)
        # identity(2) + (sin,cos)x2 dims x2 freqs = 2 + 8
        assert lib.n_features == 10
        z = jnp.array([0.5, -0.2])
        vals = np.asarray(lib(z))
        assert vals[2] == pytest.approx(np.sin(0.5))
        assert vals[3] == pytest.approx(np.cos(0.5))

    def test_poly_and_cross(self):
        lib = FeatureLibrary.from_config(
            2, poly_basis=True, poly_degree=2, poly_cross_terms=True
        )
        # identity(2) + squares(2) + cross deg2 {z0 z1} (1)
        assert lib.n_features == 5
        z = jnp.array([2.0, 3.0])
        vals = np.asarray(lib(z))
        assert 6.0 in np.round(vals, 6)  # the z0*z1 term

    def test_trig_interaction(self):
        lib = FeatureLibrary.from_config(2, trig_basis=True, trig_interaction=True)
        z = jnp.array([0.7, 1.3])
        vals = np.asarray(lib(z))
        assert any(
            np.isclose(v, 0.7 * np.sin(1.3), atol=1e-12) for v in vals
        )
        assert any(
            np.isclose(v, 1.3 * np.sin(0.7), atol=1e-12) for v in vals
        )

    def test_finite_difference(self):
        t = np.linspace(0, 1, 51)
        x = np.stack([t**2, np.sin(t)], axis=1)
        dx = np.asarray(finite_difference(jnp.asarray(x), t[1] - t[0]))
        np.testing.assert_allclose(dx[:, 0], 2 * t, atol=5e-3)
        np.testing.assert_allclose(dx[:, 1], np.cos(t), atol=5e-3)


class TestSINDy:
    def test_recovers_cartpole_discrete(self, benchmark, trajs):
        """With the trig+identity library, discrete SINDy on cartpole data
        predicts holdout transitions accurately."""
        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        holdout = benchmark.gen_trajs_batch(seed=9, n_trajs=3, traj_len=60)[0]
        preds = model.pred_batch(holdout.obs[:-1], holdout.ctrls[:-1])
        errs = np.asarray(preds) - np.asarray(holdout.obs[1:])
        assert np.abs(errs).max() < 5e-2

    def test_continuous_mode(self, benchmark):
        # Continuous mode differentiates the trajectory numerically, so
        # train on *smooth* (multisine) excitation — with i.i.d. random
        # controls the centered differences mix adjacent controls and the
        # derivative targets are dominated by that noise.
        b = CartpoleSwingupBenchmark(data_gen_method="multisine")
        smooth = b.gen_trajs_batch(seed=11, n_trajs=100, traj_len=100)
        model = SINDy(
            b.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="continuous",
        )
        model.train(smooth)
        holdout = b.gen_trajs_batch(seed=9, n_trajs=2, traj_len=40)[0]
        preds = model.pred_batch(holdout.obs[:-1], holdout.ctrls[:-1])
        errs = np.asarray(preds) - np.asarray(holdout.obs[1:])
        assert np.abs(errs).mean() < 2e-2
        assert np.abs(errs).max() < 0.5

    def test_stlsq_sparsifies(self, benchmark, trajs):
        """A generous threshold prunes spurious library terms."""
        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-1,
            trig_basis=True, trig_freq=2, trig_interaction=True,
            poly_basis=True, poly_degree=2,
            time_mode="discrete",
        )
        model.train(trajs)
        coeffs = np.asarray(model.coeffs)
        # sparse: many exact zeros
        assert (np.abs(coeffs) < 1e-12).mean() > 0.3
        assert np.isfinite(coeffs).all()

    def test_lasso_mode(self, benchmark, trajs):
        model = SINDy(
            benchmark.system, method="lasso", lasso_alpha=1e-5,
            trig_basis=True, trig_interaction=True, time_mode="discrete",
        )
        model.train(trajs)
        holdout = benchmark.gen_trajs_batch(seed=9, n_trajs=1, traj_len=30)[0]
        preds = model.pred_batch(holdout.obs[:-1], holdout.ctrls[:-1])
        errs = np.asarray(preds) - np.asarray(holdout.obs[1:])
        assert np.abs(errs).max() < 0.5

    def test_pred_diff_matches_fd(self, benchmark, trajs):
        model = SINDy(
            benchmark.system, method="lstsq", trig_basis=True,
            time_mode="discrete",
        )
        model.train(trajs)
        s = jnp.array([0.5, 0.1, -0.2, 0.3])
        u = jnp.array([1.0])
        _, jx, ju = model.pred_diff(s, u)
        eps = 1e-6
        fd = np.zeros((4, 4))
        for i in range(4):
            dp = np.asarray(model.pred(s.at[i].add(eps), u))
            dm = np.asarray(model.pred(s.at[i].add(-eps), u))
            fd[:, i] = (dp - dm) / (2 * eps)
        np.testing.assert_allclose(np.asarray(jx), fd, atol=1e-5)

    def test_factory_config_space(self, benchmark):
        factory = SINDyFactory(benchmark.system)
        cs = factory.get_configuration_space()
        cfg = cs.get_default_configuration()
        assert "lasso_alpha" not in cfg or cfg["method"] == "lasso"
        cfg["method"] = "lasso"
        assert "lasso_alpha" in cfg
        cfg["trig_basis"] = "true"
        assert "trig_freq" in cfg


def np_ilqr_reference(pred_diff, obs_cost_hess, ctrl_cost_hess, term_cost_hess,
                      eval_obj, x0, H, ds, dc, max_iter=50):
    """Independent numpy re-derivation of the reference iLQR iteration
    (ilqr.py:100-265) for golden comparison."""
    states = np.zeros((H + 1, ds))
    ctrls = np.zeros((H, dc))
    Jacs = np.zeros((H, ds, ds + dc))
    states[0] = x0
    for i in range(H):
        states[i + 1], jx, ju = pred_diff(states[i], ctrls[i])
        Jacs[i, :, :ds] = jx
        Jacs[i, :, ds:] = ju
    obj = eval_obj(states, ctrls)
    Ks = np.zeros((H, dc, ds))
    ks = np.zeros((H, dc))
    ls_max_iter, ls_discount, ls_cost_threshold, u_threshold = 10, 0.2, 0.3, 1e-3
    alphas = np.array([ls_discount**i for i in range(ls_max_iter)])
    for itr in range(max_iter):
        _, cost_jac, cost_hess = term_cost_hess(states[H])
        Vn = np.zeros((ds, ds))
        vn = np.zeros(ds)
        Vn[:4, :4] = cost_hess
        vn[:4] = cost_jac
        lin_red = quad_red = 0.0
        Ct = np.zeros((ds + dc, ds + dc))
        ct = np.zeros(ds + dc)
        for t in range(H, 0, -1):
            Q = np.zeros((ds, ds)); Qx = np.zeros(ds)
            _, Qx[:4], Q[:4, :4] = obs_cost_hess(states[t - 1])
            _, Ru, R = ctrl_cost_hess(ctrls[t - 1])
            Ct[:ds, :ds] = Q * 0.05
            Ct[ds:, ds:] = R * 0.05
            ct[:ds] = Qx * 0.05
            ct[ds:] = Ru * 0.05
            Qt = Ct + Jacs[t - 1].T @ Vn @ Jacs[t - 1]
            qt = ct + Jacs[t - 1].T @ vn
            Ks[t - 1] = -np.linalg.solve(Qt[ds:, ds:], Qt[ds:, :ds])
            ks[t - 1] = -np.linalg.solve(Qt[ds:, ds:], qt[ds:])
            lin_red += qt[ds:] @ ks[t - 1]
            quad_red += ks[t - 1] @ Qt[ds:, ds:] @ ks[t - 1]
            Vn = (Qt[:ds, :ds] + Qt[:ds, ds:] @ Ks[t - 1]
                  + Ks[t - 1].T @ Qt[ds:, :ds]
                  + Ks[t - 1].T @ Qt[ds:, ds:] @ Ks[t - 1])
            vn = (qt[:ds] + Qt[:ds, ds:] @ ks[t - 1]
                  + Ks[t - 1].T @ (qt[ds:] + Qt[ds:, ds:] @ ks[t - 1]))
        ls_states = np.zeros((ls_max_iter, H + 1, ds))
        ls_ctrls = np.zeros((ls_max_iter, H, dc))
        ls_states[:, 0] = x0
        for i in range(H):
            for j, alpha in enumerate(alphas):
                ls_ctrls[j, i] = np.clip(
                    alpha * ks[i] + ctrls[i] + Ks[i] @ (ls_states[j, i] - states[i]),
                    -20.0, 20.0,
                )
                ls_states[j, i + 1] = pred_diff(ls_states[j, i], ls_ctrls[j, i])[0]
        ks_norm = np.linalg.norm(ks)
        best_obj = np.inf
        best_idx = None
        for j, alpha in enumerate(alphas):
            new_obj = eval_obj(ls_states[j], ls_ctrls[j])
            expect = alpha * lin_red + alpha**2 * quad_red / 2
            if (obj - new_obj) / (-expect) > ls_cost_threshold:
                best_obj, best_idx = new_obj, j
                break
            if new_obj < best_obj:
                best_obj, best_idx = new_obj, j
            if ks_norm < u_threshold:
                break
        ls_success = best_obj < obj or ks_norm < u_threshold
        if (not ls_success and new_obj > obj + 1e-3) or best_idx is None:
            break
        new_ctrls = ls_ctrls[best_idx]
        new_states = ls_states[best_idx]
        if ls_success:
            for i in range(H):
                _, jx, ju = pred_diff(new_states[i], new_ctrls[i])
                Jacs[i, :, :ds] = jx
                Jacs[i, :, ds:] = ju
            new_obj = eval_obj(new_states, new_ctrls)
        du = np.linalg.norm(new_ctrls - ctrls)
        states, ctrls, obj = new_states.copy(), new_ctrls.copy(), new_obj
        if du < u_threshold:
            break
    return states, ctrls, obj


class TestILQRGolden:
    def test_matches_numpy_reference_iteration(self, benchmark, trajs):
        """Our fused iLQR reproduces the reference algorithm run in plain
        numpy on the same SINDy model."""
        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        task = benchmark.task.copy()
        Q = np.diag([10.0, 0.1, 0.1, 0.1])
        R = 0.01 * np.eye(1)
        F = np.diag([10.0, 0.1, 0.1, 0.1])
        cost = QuadCost(benchmark.system, Q, R, F, goal=np.zeros(4))
        task.set_cost(cost)

        H = 10
        con = IterativeLQR(benchmark.system, task, model, horizon=H)
        x0 = jnp.array([0.5, 0.0, 0.0, 0.0])
        conv, xs, us, Ks, ks = con.compute_ilqr(x0, jnp.zeros((H, 1)))

        mp = model.params
        _pred_diff_jit = jax.jit(
            lambda s, u: (
                model.pred_core(mp, s, u),
                jax.jacfwd(lambda ss: model.pred_core(mp, ss, u))(s),
                jax.jacfwd(lambda uu: model.pred_core(mp, s, uu))(u),
            )
        )

        def pred_diff(s, u):
            p, jx, ju = _pred_diff_jit(jnp.asarray(s), jnp.asarray(u))
            return np.asarray(p), np.asarray(jx), np.asarray(ju)

        def obs_cost_hess(x):
            c, g, h = cost.eval_obs_cost_hess(jnp.asarray(x))
            return float(c), np.asarray(g), np.asarray(h)

        def ctrl_cost_hess(u):
            c, g, h = cost.eval_ctrl_cost_hess(jnp.asarray(u))
            return float(c), np.asarray(g), np.asarray(h)

        def eval_obj(states, ctrls):
            obj = 0.0
            for i in range(H):
                obj += 0.05 * (
                    float(cost.eval_obs_cost(jnp.asarray(states[i, :4])))
                    + float(cost.eval_ctrl_cost(jnp.asarray(ctrls[i])))
                )
            return obj + float(cost.eval_term_obs_cost(jnp.asarray(states[-1, :4])))

        ref_states, ref_ctrls, ref_obj = np_ilqr_reference(
            pred_diff, obs_cost_hess, ctrl_cost_hess,
            lambda x: obs_cost_hess(x) if False else (
                float(cost.eval_term_obs_cost(jnp.asarray(x))),
                np.asarray(cost.eval_term_obs_cost_diff(jnp.asarray(x))[1]),
                np.asarray(cost.eval_term_obs_cost_hess(jnp.asarray(x))[2]),
            ),
            eval_obj, np.asarray(x0), H, 4, 1,
        )
        np.testing.assert_allclose(np.asarray(us), ref_ctrls, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(xs), ref_states, rtol=1e-4, atol=1e-6)


class TestILQRSwingup:
    def test_cartpole_swingup(self, benchmark, trajs):
        """The headline demo: SINDy + iLQR swings the cartpole up from
        theta=3.1 and holds it (BASELINE configs[1])."""
        model = SINDy(
            benchmark.system, method="lstsq", threshold=1e-3,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        model.train(trajs)
        task = benchmark.task.copy()
        task.set_cost(
            QuadCost(
                benchmark.system,
                np.diag([10.0, 0.1, 0.01, 0.01]),
                0.001 * np.eye(1),
                np.diag([10.0, 0.1, 0.01, 0.01]),
                goal=np.zeros(4),
            )
        )
        con = IterativeLQR(benchmark.system, task, model, horizon=20)
        traj = simulate(
            con,
            benchmark.task.get_init_obs(),
            term_cond=benchmark.task.term_cond,
            dynamics=benchmark.dynamics,
            max_steps=200,
        )
        obs = np.asarray(traj.obs)
        assert traj.size == 200
        # swung up: final angle within threshold of upright
        final_theta = obs[-10:, 0]
        assert np.abs(final_theta).max() < 0.2, f"final thetas {final_theta}"
        # pole dims (theta, omega) settle within the 0.2 threshold for
        # the vast majority of post-swing steps (the x-drift tradeoff is
        # what the AutoML tuner exists to resolve)
        pole_bad = (np.abs(obs[:, :2]) > 0.2).any(axis=1)
        assert pole_bad[50:].mean() < 0.2, f"late bad frac {pole_bad[50:].mean()}"

    def test_factory(self, benchmark, trajs):
        model = SINDy(
            benchmark.system, method="lstsq", trig_basis=True,
            time_mode="discrete",
        )
        model.train(trajs)
        task = benchmark.task.copy()
        task.set_cost(
            QuadCost(benchmark.system, np.eye(4), np.eye(1), goal=np.zeros(4))
        )
        factory = IterativeLQRFactory(benchmark.system)
        cfg = factory.get_configuration_space().get_default_configuration()
        assert cfg["horizon"] == 20
        con = factory(cfg, task, model)
        assert con.horizon == 20


class TestAnalyticJacobian:
    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(),
            dict(trig_basis=True, trig_freq=2),
            dict(trig_basis=True, trig_interaction=True),
            dict(poly_basis=True, poly_degree=3),
            dict(poly_basis=True, poly_degree=3, poly_cross_terms=True),
            dict(trig_basis=True, trig_interaction=True,
                 poly_basis=True, poly_degree=2, poly_cross_terms=True),
        ],
    )
    def test_matches_jacfwd(self, kwargs):
        lib = FeatureLibrary.from_config(4, **kwargs)
        rng = np.random.default_rng(0)
        z = jnp.asarray(rng.normal(size=4))
        J_analytic = np.asarray(lib.jacobian(z))
        J_ad = np.asarray(jax.jacfwd(lib)(z))
        np.testing.assert_allclose(J_analytic, J_ad, rtol=1e-9, atol=1e-10)

    def test_batched_shapes(self):
        lib = FeatureLibrary.from_config(3, trig_basis=True)
        z = jnp.ones((5, 7, 3))
        J = lib.jacobian(z)
        assert J.shape == (5, 7, lib.n_features, 3)

    def test_zero_input_cross_terms(self):
        """Cross-term derivative must not NaN at z=0 (0 * z^-1 guard)."""
        lib = FeatureLibrary.from_config(
            3, poly_basis=True, poly_degree=3, poly_cross_terms=True
        )
        J = np.asarray(lib.jacobian(jnp.zeros(3)))
        assert np.isfinite(J).all()


def test_stlsq_gram_matches_svd_stlsq():
    """Normal-equations STLSQ (ops/lstsq.py:stlsq_gram — the shared-data
    trainer the joint fan-out vmaps per lane) recovers the same support
    and near-identical coefficients as the SVD formulation on the
    cartpole staging."""
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.core.trajectory import batch as traj_batch
    from autompc_tpu.ops.lstsq import gram_stage, stlsq, stlsq_gram
    from autompc_tpu.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60)
    skeleton = SINDy(
        b.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    tb = traj_batch(trajs.to_list())
    feats = skeleton.library(jnp.concatenate([tb.obs, tb.ctrls], axis=-1))
    A = feats.reshape(-1, skeleton.library.n_features)
    y = jnp.roll(tb.obs, -1, axis=1).reshape(-1, 4)
    rmask = tb.step_mask().reshape(-1)

    for thresh in (1e-3, 1e-2):
        c_svd = np.asarray(stlsq(A, y, thresh, mask=rmask))
        G, bv = gram_stage(A, y, mask=rmask)
        c_gram = np.asarray(stlsq_gram(G, bv, thresh))
        np.testing.assert_array_equal(c_svd != 0, c_gram != 0,
                                      err_msg=f"support at {thresh}")
        np.testing.assert_allclose(c_gram, c_svd, rtol=1e-5, atol=1e-8,
                                   err_msg=f"coefs at {thresh}")


def test_stlsq_gram_f32_ill_conditioned_library():
    """The production accelerator path stages in f32, where the normal
    equations square the conditioning; the Jacobi-scaled Cholesky
    solves must still recover the SVD formulation's support on a much
    worse-conditioned library (poly degree 3 + cross terms + trig —
    mixed column scales) than the headline trig staging."""
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.core.trajectory import batch as traj_batch
    from autompc_tpu.ops.lstsq import gram_stage, stlsq, stlsq_gram
    from autompc_tpu.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=7, n_trajs=40, traj_len=60)
    skeleton = SINDy(
        b.system, method="lstsq", threshold=1e-2,
        poly_basis=True, poly_degree=3, poly_cross_terms=True,
        trig_basis=True, trig_freq=1,
        time_mode="discrete",
    )
    tb = traj_batch(trajs.to_list())
    feats = skeleton.library(jnp.concatenate([tb.obs, tb.ctrls], axis=-1))
    A64 = feats.reshape(-1, skeleton.library.n_features)
    y64 = jnp.roll(tb.obs, -1, axis=1).reshape(-1, 4)
    rmask = tb.step_mask().reshape(-1)

    # f64 SVD reference vs f32 Gram production path.
    c_svd = np.asarray(stlsq(A64, y64, 1e-2, mask=rmask))
    A32 = A64.astype(jnp.float32)
    y32 = y64.astype(jnp.float32)
    G, bv = gram_stage(A32, y32, mask=rmask.astype(jnp.float32))
    c_gram = np.asarray(stlsq_gram(G, bv, 1e-2))

    assert np.isfinite(c_gram).all()
    np.testing.assert_array_equal(
        c_svd != 0, c_gram != 0, err_msg="support f32-gram vs f64-svd"
    )
    live = c_svd != 0
    np.testing.assert_allclose(
        c_gram[live], c_svd[live], rtol=5e-3,
        err_msg="live coefficients",
    )
