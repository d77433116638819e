"""Batched iLQR solver equivalence with vmap of the single solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control.ilqr import make_batched_ilqr_solver, make_ilqr_solver
from autompc_tpu.costs import QuadCost
from autompc_tpu.sysid import SINDy


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80)
    model = SINDy(
        b.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    cost = QuadCost(
        b.system,
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        0.001 * jnp.eye(1),
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        goal=jnp.zeros(4),
    )
    bounds = b.task.get_ctrl_bounds()
    common = dict(
        H=8, ds=4, dc=1, obsdim=4, dt=b.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=10,
    )
    return b, model, cost, common


def test_batched_matches_vmapped_single(setup):
    b, model, cost, common = setup
    single = make_ilqr_solver(model.pred_core, cost, **common)
    batched = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    rng = np.random.default_rng(0)
    B = 6
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    conv_v, xs_v, us_v, Ks_v, ks_v = jax.jit(
        jax.vmap(single, in_axes=(None, 0, 0))
    )(model.params, x0s, ug)
    conv_b, xs_b, us_b, Ks_b, ks_b = jax.jit(batched)(model.params, x0s, ug)
    np.testing.assert_array_equal(np.asarray(conv_v), np.asarray(conv_b))
    np.testing.assert_allclose(np.asarray(us_v), np.asarray(us_b), atol=1e-8)
    np.testing.assert_allclose(np.asarray(xs_v), np.asarray(xs_b), atol=1e-8)


def test_pallas_backward_matches_scan_backward(setup):
    b, model, cost, common = setup
    sc = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    # The backward kernel in interpret mode (the platform's default
    # path on the GPU); the line search stays on XLA.
    pa = make_batched_ilqr_solver(
        model.pred_core, cost, pallas_interpret=True, **common
    )
    rng = np.random.default_rng(1)
    B = 4
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    out_p = jax.jit(pa)(model.params, x0s, ug)
    out_s = jax.jit(sc)(model.params, x0s, ug)
    np.testing.assert_array_equal(np.asarray(out_p[0]), np.asarray(out_s[0]))
    np.testing.assert_allclose(
        np.asarray(out_p[2]), np.asarray(out_s[2]), atol=1e-8
    )


def test_feature_spec_ls_matches_scan_ls(setup):
    """Batched solver with a feature_spec: on the CPU the XLA line
    search runs (identical to the plain solve); with
    pallas_interpret=True the fused line-search kernel runs in
    interpret mode and gives the same solve."""
    b, model, cost, common = setup
    plain = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    fs = dict(backward="scan", feature_spec=(model.library, "coeffs"))
    with_fs = make_batched_ilqr_solver(model.pred_core, cost, **fs,
                                       **common)
    with_kernel = make_batched_ilqr_solver(
        model.pred_core, cost, pallas_interpret=True, **fs, **common
    )
    rng = np.random.default_rng(2)
    B = 4
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    out_plain = jax.jit(plain)(model.params, x0s, ug)
    out_fs = jax.jit(with_fs)(model.params, x0s, ug)
    out_k = jax.jit(with_kernel)(model.params, x0s, ug)
    for a, b_ in zip(out_fs, out_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    np.testing.assert_array_equal(np.asarray(out_k[0]),
                                  np.asarray(out_plain[0]))
    np.testing.assert_allclose(
        np.asarray(out_k[2]), np.asarray(out_plain[2]), atol=1e-8
    )


def test_affine_rollout_parallel_matches_scan():
    """Associative-scan (O(log H)-depth) affine rollout equals the
    sequential scan — the horizon-axis parallelism primitive."""
    from autompc_tpu.ops.riccati import (
        affine_rollout_parallel,
        affine_rollout_scan,
    )

    rng = np.random.default_rng(0)
    H, ds = 33, 5
    A_seq = jnp.asarray(rng.normal(size=(H, ds, ds)) * 0.4)
    b_seq = jnp.asarray(rng.normal(size=(H, ds)))
    x0 = jnp.asarray(rng.normal(size=ds))
    xs_seq = affine_rollout_scan(A_seq, b_seq, x0)
    xs_par = affine_rollout_parallel(A_seq, b_seq, x0)
    np.testing.assert_allclose(
        np.asarray(xs_par), np.asarray(xs_seq), rtol=1e-9, atol=1e-9
    )


@pytest.mark.parametrize("H,ds,dc", [(7, 3, 1), (12, 4, 2), (40, 5, 3)])
def test_tvlqr_backward_assoc_matches_scan(H, ds, dc):
    """Associative-scan TVLQR backward pass (O(log H) depth) equals the
    sequential recursion — gains, feedforwards, and the expected-
    reduction accumulators used by the line-search acceptance test."""
    from autompc_tpu.ops.riccati import (
        tvlqr_backward_assoc,
        tvlqr_backward_scan,
    )

    rng = np.random.default_rng(H * 10 + ds)
    Jx = jnp.asarray(rng.normal(size=(H, ds, ds)) * 0.4 + np.eye(ds))
    Ju = jnp.asarray(rng.normal(size=(H, ds, dc)) * 0.3)
    Cxx = jnp.asarray(
        np.stack([np.diag(rng.uniform(0.1, 2.0, ds)) for _ in range(H)])
    )
    Cuu = jnp.asarray(
        np.stack([np.diag(rng.uniform(0.05, 1.0, dc)) for _ in range(H)])
    )
    cx = jnp.asarray(rng.normal(size=(H, ds)))
    cu = jnp.asarray(rng.normal(size=(H, dc)))
    Vn = jnp.asarray(np.diag(rng.uniform(0.1, 3.0, ds)))
    vn = jnp.asarray(rng.normal(size=ds))

    Ks_s, ks_s, lin_s, quad_s = tvlqr_backward_scan(
        Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn
    )
    Ks_a, ks_a, lin_a, quad_a = tvlqr_backward_assoc(
        Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn
    )
    np.testing.assert_allclose(np.asarray(Ks_a), np.asarray(Ks_s),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ks_a), np.asarray(ks_s),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(float(lin_a), float(lin_s), rtol=1e-7)
    np.testing.assert_allclose(float(quad_a), float(quad_s), rtol=1e-7)


def test_batched_assoc_backward_matches_scan(setup):
    """backward='assoc' inside the batched solver reproduces the
    backward='scan' solve end to end."""
    b, model, cost, common = setup
    sc = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    asc = make_batched_ilqr_solver(
        model.pred_core, cost, backward="assoc", **common
    )
    rng = np.random.default_rng(2)
    B = 4
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    out_s = jax.jit(sc)(model.params, x0s, ug)
    out_a = jax.jit(asc)(model.params, x0s, ug)
    np.testing.assert_array_equal(np.asarray(out_s[0]), np.asarray(out_a[0]))
    np.testing.assert_allclose(
        np.asarray(out_s[2]), np.asarray(out_a[2]), atol=1e-6
    )


def test_fused_ls_matches_scan_ls(setup):
    """Both kernels in interpret mode (the GPU's default path for this
    solver: dc=1, diagonal QuadCost, linear-in-features model) match
    the plain XLA solve."""
    b, model, cost, common = setup
    plain = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    fused = make_batched_ilqr_solver(
        model.pred_core, cost, feature_spec=(model.library, "coeffs"),
        pallas_interpret=True, **common
    )
    rng = np.random.default_rng(5)
    B = 4
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    out_plain = jax.jit(plain)(model.params, x0s, ug)
    out_f = jax.jit(fused)(model.params, x0s, ug)
    np.testing.assert_array_equal(np.asarray(out_f[0]),
                                  np.asarray(out_plain[0]))
    np.testing.assert_allclose(
        np.asarray(out_f[2]), np.asarray(out_plain[2]), atol=1e-8
    )


def test_staged_compaction_matches_batched(setup):
    """Staged solve with aggressive compaction (chunk=2, min_bucket=2)
    is lane-for-lane identical to the single while_loop program."""
    from autompc_tpu.control.ilqr import make_staged_ilqr_solver

    b, model, cost, common = setup
    batched = make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    )
    staged = make_staged_ilqr_solver(
        model.pred_core, cost, backward="scan",
        chunk_iters=2, min_bucket=2, **common
    )
    rng = np.random.default_rng(3)
    B = 13  # odd size: exercises non-power-of-two -> bucket rounding
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1, 1, 1]))
    ug = jnp.zeros((B, common["H"], 1))
    out_b = jax.jit(batched)(model.params, x0s, ug)
    out_s = staged(model.params, x0s, ug)
    for a, v in zip(out_s, out_b):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(v), atol=1e-8
        )


def test_scheduled_compaction_matches_batched(setup):
    """Device-side scheduled compaction (one jit, argsort + gather at
    static cut points) is lane-for-lane identical to the single
    while_loop program, on both the compacted and the overflow path."""
    from autompc_tpu.control.ilqr import make_scheduled_ilqr_solver

    b, model, cost, common = setup
    batched = jax.jit(make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **common
    ))
    rng = np.random.default_rng(7)
    B = 16
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1, 1, 1]))
    ug = jnp.zeros((B, common["H"], 1))
    out_b = batched(model.params, x0s, ug)

    # Generous cuts: actives fit, compaction actually runs.
    sched = jax.jit(make_scheduled_ilqr_solver(
        model.pred_core, cost, backward="scan",
        schedule=((6, 0.5), (8, 0.25)), **common
    ))
    # Impossible cut (12.5% bucket after 1 iteration): overflow path.
    over = jax.jit(make_scheduled_ilqr_solver(
        model.pred_core, cost, backward="scan",
        schedule=((1, 0.125),), **common
    ))
    for solver in (sched, over):
        out_s = solver(model.params, x0s, ug)
        for a, v in zip(out_s, out_b):
            np.testing.assert_allclose(
                np.asarray(a).astype(float),
                np.asarray(v).astype(float), atol=1e-8
            )


def test_quad_cost_batch_per_lane(setup):
    """Per-lane diagonal quadratic costs (quad_cost_batch=True):
    (a) one iteration matches the fixed-QuadCost solver analytically
    (same expansions/objective up to f32 op-order noise);
    (b) the full batched solve is bitwise consistent with itself at
    B=1 per lane (batching independence);
    (c) the scheduled compaction variant passes cost params through."""
    from autompc_tpu.control.ilqr import make_scheduled_ilqr_solver

    b, model, cost, common = setup
    goal = jnp.zeros(4)
    rng = np.random.default_rng(11)
    B = 6
    Qd = jnp.asarray(rng.uniform(0.01, 10, (B, 4)))
    Rd = jnp.asarray(rng.uniform(1e-3, 1, (B, 1)))
    Fd = jnp.asarray(rng.uniform(0.01, 10, (B, 4)))
    cps = dict(Qdiag=Qd, Rdiag=Rd, Fdiag=Fd)
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1, 1, 1]))
    ug = jnp.zeros((B, common["H"], 1))

    quad = jax.jit(make_batched_ilqr_solver(
        model.pred_core, None, backward="scan",
        quad_cost_batch=True, quad_goal=goal, **common
    ))
    out_q = quad(model.params, x0s, ug, cps)

    # (a) single-iteration analytic agreement with fixed QuadCost.
    kw1 = dict(common, max_iter=1)
    from autompc_tpu.costs import QuadCost

    lane = 2
    fixed1 = jax.jit(make_batched_ilqr_solver(
        model.pred_core,
        QuadCost(b.system, jnp.diag(Qd[lane]), jnp.diag(Rd[lane]),
                 jnp.diag(Fd[lane]), goal=goal),
        backward="scan", **kw1
    ))
    quad1 = jax.jit(make_batched_ilqr_solver(
        model.pred_core, None, backward="scan",
        quad_cost_batch=True, quad_goal=goal, **kw1
    ))
    of = fixed1(model.params, x0s[lane:lane + 1], ug[:1])
    oq = quad1(
        model.params, x0s[lane:lane + 1], ug[:1],
        jax.tree_util.tree_map(lambda a: a[lane:lane + 1], cps),
    )
    for a, v in zip(oq, of):
        np.testing.assert_allclose(
            np.asarray(a).astype(float), np.asarray(v).astype(float),
            atol=1e-4
        )

    # (b) full solve: batch of 6 == six B=1 solves, bitwise.
    for i in range(B):
        out_1 = quad(
            model.params, x0s[i:i + 1], ug[:1],
            jax.tree_util.tree_map(lambda a: a[i:i + 1], cps),
        )
        for a, v in zip(out_q, out_1):
            np.testing.assert_allclose(
                np.asarray(a)[i].astype(float),
                np.asarray(v)[0].astype(float), atol=1e-8
            )

    # (c) scheduled variant.
    sched = jax.jit(make_scheduled_ilqr_solver(
        model.pred_core, None, backward="scan",
        quad_cost_batch=True, quad_goal=goal,
        schedule=((4, 0.5),), **common
    ))
    out_s = sched(model.params, x0s, ug, cps)
    for a, v in zip(out_s, out_q):
        np.testing.assert_allclose(
            np.asarray(a).astype(float), np.asarray(v).astype(float),
            atol=1e-8
        )


def test_parse_schedule():
    from autompc_tpu.control.ilqr import parse_schedule

    assert parse_schedule(None) is None
    assert parse_schedule("") is None
    assert parse_schedule("20:0.5,38:0.125") == ((20, 0.5), (38, 0.125))
    with pytest.raises(ValueError, match="size_frac"):
        parse_schedule("10:1.5")
    with pytest.raises(ValueError):
        parse_schedule("nonsense")


def test_feature_mask_matches_dense(setup):
    """Static feature sparsity (feature_mask) reproduces the dense
    feature-spec solve — the masked-out columns are exactly zero on a
    thresholded STLSQ fit, so filtering terms at trace time is a pure
    reordering of the same math."""
    b, model, cost, common = setup
    coeffs = np.asarray(model.coeffs)
    active = tuple(
        int(k) for k in np.flatnonzero(np.any(np.abs(coeffs) > 0, axis=0))
    )
    assert 0 < len(active) < coeffs.shape[1]

    kw = dict(backward="scan", feature_spec=(model.library, "coeffs"),
              pallas_interpret=True)
    dense = make_batched_ilqr_solver(model.pred_core, cost, **kw, **common)
    masked = make_batched_ilqr_solver(
        model.pred_core, cost, feature_mask=active, **kw, **common
    )
    masked_bool = make_batched_ilqr_solver(
        model.pred_core, cost,
        feature_mask=[k in active for k in range(coeffs.shape[1])],
        **kw, **common
    )
    rng = np.random.default_rng(7)
    B = 4
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))
    out_d = jax.jit(dense)(model.params, x0s, ug)
    out_m = jax.jit(masked)(model.params, x0s, ug)
    out_mb = jax.jit(masked_bool)(model.params, x0s, ug)
    np.testing.assert_allclose(
        np.asarray(out_m[2]), np.asarray(out_d[2]), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out_mb[2]), np.asarray(out_m[2]), atol=1e-7
    )


def test_feature_mask_validation(setup):
    b, model, cost, common = setup
    with pytest.raises(ValueError, match="feature_mask needs"):
        make_batched_ilqr_solver(
            model.pred_core, cost, feature_mask=(0, 1), **common
        )
    with pytest.raises(ValueError, match="masks out every"):
        make_batched_ilqr_solver(
            model.pred_core, cost,
            feature_spec=(model.library, "coeffs"),
            feature_mask=[False] * model.library.n_features, **common
        )


def test_batch_params_matches_vmapped_single(setup):
    """batch_params=True (one model per lane) == vmap of the single
    solver over (params, x0, uguess)."""
    b, model, cost, common = setup
    # Three genuinely different SINDy fits (different STLSQ thresholds).
    trajs = b.gen_trajs_batch(seed=7, n_trajs=40, traj_len=60)
    coeffs = []
    for thr in (1e-4, 1e-3, 1e-2):
        m = SINDy(
            b.system, method="lstsq", threshold=thr,
            trig_basis=True, trig_freq=1, trig_interaction=True,
            time_mode="discrete",
        )
        m.train(trajs)
        coeffs.append(m.coeffs)
    params_b = {"coeffs": jnp.stack(coeffs)}
    B = 3
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)))
    ug = jnp.zeros((B, common["H"], 1))

    single = make_ilqr_solver(model.pred_core, cost, **common)
    out_v = jax.jit(jax.vmap(single, in_axes=(0, 0, 0)))(
        params_b, x0s, ug
    )
    batched = jax.jit(make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", batch_params=True,
        **common,
    ))
    out_b = batched(params_b, x0s, ug)
    np.testing.assert_array_equal(np.asarray(out_v[0]), np.asarray(out_b[0]))
    for a, v in zip(out_b[1:], out_v[1:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(v), atol=1e-8)

    # Per-lane params + per-lane quadratic costs + compaction: the
    # joint-tuning configuration. Scheduled == unscheduled.
    from autompc_tpu.control.ilqr import make_scheduled_ilqr_solver

    cps = dict(
        Qdiag=jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
        Rdiag=jnp.asarray(rng.uniform(1e-3, 1, (B, 1))),
        Fdiag=jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
    )
    kw = dict(common, backward="scan", batch_params=True,
              quad_cost_batch=True, quad_goal=jnp.zeros(4))
    plain = jax.jit(make_batched_ilqr_solver(model.pred_core, None, **kw))
    sched = jax.jit(make_scheduled_ilqr_solver(
        model.pred_core, None, schedule=((4, 0.5),), **kw
    ))
    out_p = plain(params_b, x0s, ug, cps)
    out_s = sched(params_b, x0s, ug, cps)
    for a, v in zip(out_s, out_p):
        np.testing.assert_allclose(
            np.asarray(a).astype(float), np.asarray(v).astype(float),
            atol=1e-8,
        )


@pytest.mark.slow
def test_reg_term_matches_sum_cost_single(setup):
    """quad_cost_batch + reg_matrix (the GaussRegFactory term): every
    lane of the batched solve equals the single solver run on the
    explicit SumCost
    ``QuadCost(diag, goal) + QuadCost(regw * S, 0, 0, goal=mu)``
    (costs/sum_cost.py algebra) — pinning the per-lane-weighted shared
    dense stage quadratic against the generic cost-hessian path."""
    b, model, cost, common = setup
    goal = jnp.zeros(4)
    rng = np.random.default_rng(13)
    B = 3
    Qd = jnp.asarray(rng.uniform(0.01, 10, (B, 4)))
    Rd = jnp.asarray(rng.uniform(1e-3, 1, (B, 1)))
    Fd = jnp.asarray(rng.uniform(0.01, 10, (B, 4)))
    regw = jnp.asarray(rng.uniform(0.1, 5.0, (B,)))
    A = rng.normal(size=(4, 4))
    S = A @ A.T / 4 + np.eye(4)                       # symmetric SPD
    mu = rng.uniform(-0.5, 0.5, 4)
    cps = dict(Qdiag=Qd, Rdiag=Rd, Fdiag=Fd, regw=regw)
    x0s = jnp.asarray(
        rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1, 1, 1])
    )
    ug = jnp.zeros((B, common["H"], 1))

    batched = jax.jit(make_batched_ilqr_solver(
        model.pred_core, None, backward="scan",
        quad_cost_batch=True, quad_goal=goal,
        reg_matrix=jnp.asarray(S), reg_goal=jnp.asarray(mu), **common
    ))
    out_b = batched(model.params, x0s, ug, cps)

    for lane in range(B):
        sum_cost = QuadCost(
            b.system, jnp.diag(Qd[lane]), jnp.diag(Rd[lane]),
            jnp.diag(Fd[lane]), goal=goal,
        ) + QuadCost(
            b.system, float(regw[lane]) * jnp.asarray(S),
            jnp.zeros((1, 1)), jnp.zeros((4, 4)), goal=jnp.asarray(mu),
        )
        single = jax.jit(
            make_ilqr_solver(model.pred_core, sum_cost, **common)
        )
        conv, xs, us, Ks, ks = single(model.params, x0s[lane], ug[0])
        assert bool(conv) == bool(out_b[0][lane]), lane
        np.testing.assert_allclose(
            np.asarray(out_b[2][lane]), np.asarray(us), atol=1e-7,
            err_msg=f"lane {lane} controls",
        )
        np.testing.assert_allclose(
            np.asarray(out_b[1][lane]), np.asarray(xs), atol=1e-7,
            err_msg=f"lane {lane} states",
        )
