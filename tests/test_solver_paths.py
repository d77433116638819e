"""The batched iLQR solver's XLA paths against the vmapped single solver,
and the choice between XLA paths and kernels by platform and input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import autompc_tpu.ops.pallas_linesearch as pallas_linesearch
import autompc_tpu.ops.pallas_riccati as pallas_riccati
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control.ilqr import (
    kernels_available,
    make_batched_ilqr_solver,
    make_ilqr_solver,
)
from autompc_tpu.costs import QuadCost
from autompc_tpu.sysid import SINDy

H = 6


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60)
    model = SINDy(
        b.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    bounds = b.task.get_ctrl_bounds()
    common = dict(
        H=H, ds=4, dc=1, obsdim=4, dt=b.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=6,
    )
    rng = np.random.default_rng(0)
    B = 4
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)))
    cost_params = {
        "Qdiag": jnp.asarray(rng.uniform(0.1, 5.0, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 0.5, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.1, 5.0, (B, 4))),
    }
    return model, common, x0s, cost_params


def _quad(system, cp, b):
    return QuadCost(system, jnp.diag(cp["Qdiag"][b]),
                    jnp.diag(cp["Rdiag"][b]), jnp.diag(cp["Fdiag"][b]),
                    goal=jnp.zeros(4))


def _assert_same(out, ref):
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                   rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize(
    "backward,variant",
    [
        ("scan", "shared"), ("assoc", "shared"),
        ("scan", "per_lane_params"), ("assoc", "per_lane_params"),
        ("scan", "quad_cost_batch"), ("assoc", "quad_cost_batch"),
        ("scan", "feature_mask"), ("scan", "horizon_mask"),
    ],
)
def test_xla_paths_match_vmapped_single(setup, backward, variant):
    """Each XLA configuration of the batched solver reproduces the
    vmapped single-lane solver lane for lane (CPU, x64)."""
    model, common, x0s, cp = setup
    system = CartpoleSwingupBenchmark().system
    B = x0s.shape[0]
    ug = jnp.zeros((B, H, 1))
    base_cost = _quad(system, cp, 0)
    params = model.params
    if variant in ("shared", "feature_mask"):
        kw = {}
        if variant == "feature_mask":
            live = np.flatnonzero(
                np.any(np.abs(np.asarray(model.coeffs)) > 0, 0))
            kw = dict(feature_spec=(model.library, "coeffs"),
                      feature_mask=tuple(int(k) for k in live))
        solve = make_batched_ilqr_solver(model.pred_core, base_cost,
                                         backward=backward, **kw, **common)
        out = jax.jit(solve)(params, x0s, ug)
        single = make_ilqr_solver(model.pred_core, base_cost, **common)
        ref = jax.jit(jax.vmap(single, in_axes=(None, 0, 0)))(params, x0s,
                                                             ug)
    elif variant == "per_lane_params":
        scale = jnp.asarray(np.linspace(0.97, 1.03, B))[:, None, None]
        pb = {"coeffs": params["coeffs"][None] * scale}
        solve = make_batched_ilqr_solver(model.pred_core, base_cost,
                                         backward=backward,
                                         batch_params=True, **common)
        out = jax.jit(solve)(pb, x0s, ug)
        single = make_ilqr_solver(model.pred_core, base_cost, **common)
        ref = jax.jit(jax.vmap(single, in_axes=(0, 0, 0)))(pb, x0s, ug)
    else:
        kw = dict(quad_cost_batch=True, quad_goal=jnp.zeros(4))
        cpm = dict(cp)
        if variant == "horizon_mask":
            kw["horizon_mask"] = True
            cpm["heff"] = jnp.full((B,), H, jnp.int32)
        solve = make_batched_ilqr_solver(model.pred_core, None,
                                         backward=backward, **kw, **common)
        out = jax.jit(solve)(params, x0s, ug, cpm)
        refs = [
            jax.jit(make_ilqr_solver(model.pred_core, _quad(system, cp, b),
                                     **common))(params, x0s[b], ug[b])
            for b in range(B)
        ]
        ref = [jnp.stack([r[i] for r in refs]) for i in range(5)]
    tol = 1e-5 if backward == "assoc" else 1e-8
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))
    for o, r in zip(out[1:3], ref[1:3]):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=tol,
                                   atol=tol)


def test_kernels_available_by_platform():
    assert jax.default_backend() == "cpu"
    assert not kernels_available()
    assert kernels_available(pallas_interpret=True)


def _broken(*args, **kwargs):
    raise RuntimeError("kernel called")


@pytest.mark.parametrize(
    "extra,interpret,kernel",
    [
        # dc=1 + diagonal QuadCost: the backward kernel.
        (dict(), True, "backward"),
        # A linear-in-features model: the line-search kernel too.
        (dict(backward="scan", feature_spec=True), True, "line_search"),
        # backward="scan" names the XLA recursion explicitly.
        (dict(backward="scan"), True, None),
        # A dense (non-diagonal) cost: no backward kernel.
        (dict(dense_cost=True), True, None),
        # On the CPU without interpret mode: the XLA paths.
        (dict(feature_spec=True), False, None),
    ],
)
def test_path_choice_raises_rather_than_falls_back(
    setup, monkeypatch, extra, interpret, kernel
):
    """Where a kernel applies it is called, and its failure reaches the
    caller: the solver never falls back to the XLA path."""
    model, common, x0s, cp = setup
    system = CartpoleSwingupBenchmark().system
    monkeypatch.setattr(pallas_riccati, "pallas_tvlqr_backward_quad",
                        _broken)
    monkeypatch.setattr(pallas_linesearch, "pallas_fused_line_search",
                        _broken)
    extra = dict(extra)
    cost = _quad(system, cp, 0)
    if extra.pop("dense_cost", False):
        M = np.eye(4) + 0.1
        cost = QuadCost(system, jnp.asarray(M), 0.01 * jnp.eye(1),
                        jnp.asarray(M), goal=jnp.zeros(4))
    if extra.pop("feature_spec", False):
        extra["feature_spec"] = (model.library, "coeffs")
    solve = make_batched_ilqr_solver(model.pred_core, cost,
                                     pallas_interpret=interpret, **extra,
                                     **common)
    ug = jnp.zeros((x0s.shape[0], H, 1))
    if kernel is None:
        out = solve(model.params, x0s, ug)
        assert out[1].shape == (x0s.shape[0], H + 1, 4)
    else:
        with pytest.raises(RuntimeError, match="kernel called"):
            solve(model.params, x0s, ug)


def test_backward_validation(setup):
    model, common, _, _ = setup
    with pytest.raises(ValueError, match="backward must be"):
        make_batched_ilqr_solver(model.pred_core, None, backward="pallas",
                                 **common)
