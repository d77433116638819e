"""Pallas (Triton route) fused line-search kernel vs a plain reference,
in interpret mode: every alpha rolled out with ``lax.scan``, the iLQR
objective, the reference acceptance rule (autompc/control/ilqr.py:
208-233) and ``jax.jacfwd`` Jacobians along the selected trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.ops.pallas_linesearch import (
    BLOCK_B,
    pallas_fused_line_search,
    tree_sum,
)
from autompc_tpu.sysid import SINDy

ALPHAS = tuple(0.2 ** i for i in range(10))


@pytest.fixture(scope="module")
def model():
    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60)
    m = SINDy(
        b.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    m.train(trajs)
    return m


def reference(pred_core, params, x0, xs, us, Ks, ks, alphas, umin, umax,
              stage_cost, term_cost, dt, obj0, lin, quad, ks_small,
              thresh=0.3):
    """One lane: (new_xs, new_us, new_obj, success, failed, Jx, Ju)."""
    H = us.shape[0]
    alphas = jnp.asarray(alphas)

    def rollout(alpha):
        def step(x, inp):
            xbar, ubar, K, k = inp
            u = jnp.clip(alpha * k + ubar + K @ (x - xbar), umin, umax)
            x1 = pred_core(params, x, u)
            return x1, (x1, u)

        _, (xs1, us1) = jax.lax.scan(step, x0, (xs[:H], us, Ks, ks))
        return jnp.concatenate([x0[None], xs1], axis=0), us1

    ls_xs, ls_us = jax.vmap(rollout)(alphas)
    objs = jax.vmap(lambda a, b: dt * jnp.sum(jax.vmap(stage_cost)(
        a[:H], b)) + term_cost(a[H]))(ls_xs, ls_us)
    expect = alphas * lin + alphas ** 2 * quad / 2
    ratio = jnp.where(jnp.abs(expect) > 1e-30, (obj0 - objs) / -expect,
                      -jnp.inf)
    accept = ratio > thresh
    any_acc, first = jnp.any(accept), jnp.argmax(accept)
    chosen = jnp.where(ks_small, 0,
                       jnp.where(any_acc, first, jnp.argmin(objs)))
    last = jnp.where(ks_small, 0,
                     jnp.where(any_acc, first, len(alphas) - 1))
    success = (objs[chosen] < obj0) | ks_small
    failed = ~success & (objs[last] > obj0 + 1e-3)
    sel = jnp.where(success, chosen, last)
    new_xs, new_us = ls_xs[sel], ls_us[sel]
    Jx = jax.vmap(jax.jacfwd(lambda x, u: pred_core(params, x, u)))(
        new_xs[:H], new_us)
    Ju = jax.vmap(jax.jacfwd(lambda x, u: pred_core(params, x, u), 1))(
        new_xs[:H], new_us)
    return (new_xs, new_us, jnp.where(success, objs[chosen], objs[last]),
            success, failed, Jx, Ju)


def _lanes(B, H, ds, dc, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x0=jnp.asarray(rng.uniform(-1, 1, (B, ds))),
        xs=jnp.asarray(rng.uniform(-1, 1, (B, H + 1, ds))),
        us=jnp.asarray(rng.uniform(-2, 2, (B, H, dc))),
        Ks=jnp.asarray(rng.normal(size=(B, H, dc, ds)) * 0.3),
        ks=jnp.asarray(rng.normal(size=(B, H, dc))),
        # Objectives around the rollouts' scale, so some lanes accept
        # the first alpha, some a later one and some fail.
        obj0=jnp.asarray(rng.uniform(0.5, 40.0, B)),
        lin=jnp.asarray(-rng.uniform(0.1, 20.0, B)),
        quad=jnp.asarray(-rng.uniform(0.1, 20.0, B)),
        ks_small=jnp.asarray(rng.uniform(size=B) < 0.2),
    )


def _check(out, refs, tol=1e-9):
    names = ("xs", "us", "obj", "success", "failed", "Jx", "Ju")
    for name, o, r in zip(names, out, refs):
        if name in ("success", "failed"):
            np.testing.assert_array_equal(np.asarray(o), np.asarray(r))
        else:
            np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                       rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize(
    "case,B,H",
    [("shared_dense", 4, 9), ("per_lane_diag", 5, 13),
     ("per_lane_coeffs", 6, 7), ("reg", 3, 6), ("masked", 4, 5)],
)
def test_matches_reference(model, case, B, H):
    ds, dc, n = 4, 1, 4
    a = _lanes(B, H, ds, dc, seed=len(case) + B)
    rng = np.random.default_rng(B)
    lib = model.library
    fns, gts = tuple(lib._fns), lib.grad_terms
    coeffs = jnp.asarray(model.coeffs)
    params_b = [model.params] * B
    umin, umax = -1.5, 1.5
    dt = 0.05
    goal = jnp.asarray(rng.normal(size=n) * 0.1)
    Qd = jnp.asarray(rng.uniform(0.1, 5, (B, n)))
    Rd = jnp.asarray(rng.uniform(0.01, 1, (B, dc)))
    Fd = jnp.asarray(rng.uniform(0.1, 5, (B, n)))
    kw, reg = dict(diag_cost=True), None
    cost_args = (Qd, Rd, Fd, goal)
    S = mu = w = None
    if case == "shared_dense":
        M = rng.normal(size=(n, n))
        Q = jnp.asarray(M @ M.T / n + np.eye(n))
        R, F = jnp.asarray([[0.3]]), jnp.asarray(np.diag([2.0, 1, 1, 1]))
        cost_args, kw = (Q, R, F, goal), dict(diag_cost=False)
    elif case == "per_lane_coeffs":
        coeffs = coeffs[None] * jnp.asarray(
            rng.uniform(0.9, 1.1, (B,) + coeffs.shape))
        params_b = [{"coeffs": coeffs[i]} for i in range(B)]
    elif case == "reg":
        M = rng.normal(size=(n, n))
        S = jnp.asarray(M @ M.T / n)
        mu = jnp.asarray(rng.normal(size=n) * 0.1)
        w = jnp.asarray(rng.uniform(0.1, 2.0, B))
        reg = (S, mu, w)
    elif case == "masked":
        live = np.flatnonzero(np.any(np.abs(np.asarray(coeffs)) > 0, 0))
        fns = tuple(fns[k] for k in live)
        gts = tuple(gts[k] for k in live)
        coeffs = coeffs[:, live]

    out = pallas_fused_line_search(
        fns, a["x0"], a["xs"], a["us"], a["Ks"], a["ks"], coeffs, ALPHAS,
        umin, umax, *cost_args, dt, a["obj0"], a["lin"], a["quad"],
        a["ks_small"], grad_terms=gts, reg=reg, interpret=True, **kw,
    )
    for b in range(B):
        if kw["diag_cost"]:
            def stage(x, u, b=b):
                c = jnp.sum(Qd[b] * (x - goal) ** 2) + jnp.sum(Rd[b] * u * u)
                if reg is not None:
                    c = c + w[b] * (x - mu) @ S @ (x - mu)
                return c

            def term(x, b=b):
                return jnp.sum(Fd[b] * (x - goal) ** 2)
        else:
            def stage(x, u):
                return (x - goal) @ Q @ (x - goal) + u @ R @ u

            def term(x):
                return (x - goal) @ F @ (x - goal)
        refs = reference(
            model.pred_core, params_b[b], a["x0"][b], a["xs"][b],
            a["us"][b], a["Ks"][b], a["ks"][b], ALPHAS, umin, umax,
            stage, term, dt, a["obj0"][b], a["lin"][b], a["quad"][b],
            a["ks_small"][b],
        )
        _check([o[b] for o in out], refs)


def test_multi_control_matches_reference():
    """dc > 1: SINDy on a random 3-state/2-control linear system; the
    kernel's per-component feedback and clip match the scan path."""
    import autompc_tpu as ampc
    from autompc_tpu.core.trajectory import Trajectory

    rng = np.random.default_rng(3)
    n, m = 3, 2
    system = ampc.System(
        [f"x{i}" for i in range(n)], [f"u{j}" for j in range(m)], dt=0.1
    )
    A = np.eye(n) + 0.1 * rng.normal(size=(n, n)) / np.sqrt(n)
    A *= 0.95 / max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    Bm = 0.2 * rng.normal(size=(n, m))
    trajs = []
    for _ in range(20):
        T = 40
        obs = np.zeros((T, n))
        ctrls = rng.uniform(-2, 2, (T, m))
        obs[0] = rng.uniform(-1, 1, n)
        for t in range(T - 1):
            obs[t + 1] = A @ obs[t] + Bm @ ctrls[t]
        trajs.append(
            Trajectory(system, T, jnp.asarray(obs), jnp.asarray(ctrls)))
    sm = SINDy(system, method="lstsq", threshold=1e-6,
               time_mode="discrete")
    sm.train(trajs)

    B, H = 4, 7
    a = _lanes(B, H, n, m, seed=4)
    Qd = jnp.ones((B, n))
    Rd = jnp.full((B, m), 0.1)
    goal = jnp.zeros(n)
    umin, umax = -1.5 * jnp.ones(m), 1.5 * jnp.ones(m)
    out = pallas_fused_line_search(
        tuple(sm.library._fns), a["x0"], a["xs"], a["us"], a["Ks"],
        a["ks"], sm.coeffs, ALPHAS[:4], umin, umax, Qd, Rd, Qd, goal, 0.1,
        a["obj0"], a["lin"], a["quad"], a["ks_small"],
        grad_terms=sm.library.grad_terms, diag_cost=True, interpret=True,
    )
    for b in range(B):
        refs = reference(
            sm.pred_core, sm.params, a["x0"][b], a["xs"][b], a["us"][b],
            a["Ks"][b], a["ks"][b], ALPHAS[:4], umin, umax,
            lambda x, u: jnp.sum(x * x) + 0.1 * jnp.sum(u * u),
            lambda x: jnp.sum(x * x), 0.1, a["obj0"][b], a["lin"][b],
            a["quad"][b], a["ks_small"][b],
        )
        _check([o[b] for o in out], refs)


def test_multi_block(model):
    """More lanes than one program holds, with a ragged last block,
    and no Jacobian output (a library without analytic gradients)."""
    B, H = BLOCK_B + 3, 4
    a = _lanes(B, H, 4, 1, seed=9)
    Qd = jnp.ones((B, 4))
    Rd = jnp.full((B, 1), 0.01)
    goal = jnp.zeros(4)
    out = pallas_fused_line_search(
        tuple(model.library._fns), a["x0"], a["xs"], a["us"], a["Ks"],
        a["ks"], model.coeffs, ALPHAS, -20.0, 20.0, Qd, Rd, Qd, goal, 0.05,
        a["obj0"], a["lin"], a["quad"], a["ks_small"], diag_cost=True,
        interpret=True,
    )
    assert len(out) == 5 and out[0].shape == (B, H + 1, 4)
    for b in (0, BLOCK_B - 1, BLOCK_B, B - 1):
        refs = reference(
            model.pred_core, model.params, a["x0"][b], a["xs"][b],
            a["us"][b], a["Ks"][b], a["ks"][b], ALPHAS, -20.0, 20.0,
            lambda x, u: jnp.sum(x * x) + 0.01 * jnp.sum(u * u),
            lambda x: jnp.sum(x * x), 0.05, a["obj0"][b], a["lin"][b],
            a["quad"][b], a["ks_small"][b],
        )
        _check([o[b] for o in out], refs[:5])


def test_tree_sum_is_balanced():
    assert tree_sum([1.0]) == 1.0
    assert tree_sum([1.0, 2.0, 3.0, 4.0, 5.0]) == 15.0
    # Balanced pairing: ((a+b)+(c+d))+e, not a left fold.
    big, small = 1e8, 1.0
    vals = np.float32([big, small, -big, small])
    assert tree_sum(list(vals)) == np.float32(big + small) + np.float32(
        -big + small)


def test_acceptance_knife_edge_band(model):
    """At H=200 in float32 the kernel's in-register objective stays
    within summation-order noise of a float64 evaluation of the
    trajectory it returns, so acceptance can only flip on lanes whose
    ratio sits within that noise band of the threshold. A kernel change
    that biases the objective (not just reorders the sum) fails here."""
    rng = np.random.default_rng(21)
    B, H, ds = 8, 200, 4
    f32 = np.float32
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, ds)), f32)
    xs = jnp.asarray(rng.uniform(-0.5, 0.5, (B, H + 1, ds)), f32)
    us = jnp.asarray(rng.uniform(-1, 1, (B, H, 1)), f32)
    Ks = jnp.asarray(rng.normal(size=(B, H, 1, ds)) * 0.05, f32)
    ks = jnp.asarray(rng.normal(size=(B, H, 1)) * 0.1, f32)
    alphas = (1.0, 0.2)
    Qd = np.array([10.0, 0.1, 0.01, 0.01])
    dt = 0.05
    obj0 = jnp.asarray(rng.uniform(50.0, 200.0, (B,)), f32)
    lin_red = jnp.asarray(-rng.uniform(0.5, 5.0, (B,)), f32)
    quad_red = jnp.asarray(-rng.uniform(0.5, 5.0, (B,)), f32)
    threshold = 0.3
    Q = jnp.asarray(np.diag(Qd), f32)
    new_xs, new_us, new_obj, succ, failed = pallas_fused_line_search(
        tuple(model.library._fns), x0, xs, us, Ks, ks,
        jnp.asarray(model.coeffs, f32), alphas, -20.0, 20.0,
        Q, jnp.asarray([[0.001]], f32), Q, jnp.zeros(ds, f32), dt,
        obj0, lin_red, quad_red, jnp.zeros((B,), bool),
        ls_cost_threshold=threshold, interpret=True,
    )
    xs64 = np.asarray(new_xs, np.float64)
    us64 = np.asarray(new_us, np.float64)
    obj64 = dt * (np.sum(xs64[:, :H] ** 2 * Qd, axis=(1, 2))
                  + 0.001 * np.sum(us64 ** 2, axis=(1, 2))) + np.sum(
        xs64[:, H] ** 2 * Qd, axis=1)
    rel = np.abs(np.asarray(new_obj, np.float64) - obj64) / np.abs(obj64)
    assert rel.max() < 5e-6, rel.max()
    for b in range(B):
        expect = alphas[0] * float(lin_red[b]) + alphas[0] ** 2 * float(
            quad_red[b]) / 2.0
        ratio64 = (float(obj0[b]) - obj64[b]) / -expect
        f64_acc = bool(ratio64 > threshold) or bool(obj64[b] < float(obj0[b]))
        if bool(succ[b]) != f64_acc:
            assert abs(ratio64 - threshold) < 1e-4, (b, ratio64)
