"""Horizon-polymorphic iLQR (``horizon_mask=True``): one compiled
program at H_max serves every per-lane effective horizon by making
padded steps inert (frozen dynamics, Jx=I/Ju=0, zero stage
cost/gradients, controls pinned). These tests pin the padding to be
ALGEBRAICALLY exact: a masked solve at heff=h equals a dedicated solver
compiled at H=h lane-for-lane (CPU x64), and heff=H equals the
unmasked solver.

Motivation: the AutoML tuner's controller-horizon hyperparameter
otherwise compiles one program per distinct horizon (reference space:
autompc/control/ilqr.py:24-27). The unmasked solves run the backward
kernel in interpret mode; the masked ones take the XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control.ilqr import make_batched_ilqr_solver
from autompc_tpu.sysid import MLP


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    trajs = b.gen_trajs_batch(seed=42, n_trajs=30, traj_len=60)
    model = MLP(
        b.system, n_hidden_layers=1, hidden_size_1=16,
        n_train_iters=5, seed=3,
    )
    model.train(trajs.to_list())
    bounds = b.task.get_ctrl_bounds()
    kw = dict(
        ds=4, dc=1, obsdim=4, dt=b.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=8,
        quad_cost_batch=True, quad_goal=np.zeros(4),
        backward="auto", pallas_interpret=True,
        pred_diff=lambda p, x, u: model.pred_diff_core(p, x, u),
    )
    rng = np.random.default_rng(5)
    B = 6
    cost = {
        "Qdiag": jnp.asarray(rng.uniform(0.1, 5.0, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 0.5, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.1, 5.0, (B, 4))),
    }
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 4)))
    return model, kw, cost, x0s, B


def _solve(model, kw, cost, x0s, H, heff=None):
    solver = make_batched_ilqr_solver(
        model.pred_core, None, H=H,
        horizon_mask=heff is not None, **kw
    )
    B = x0s.shape[0]
    cp = dict(cost)
    if heff is not None:
        cp["heff"] = jnp.asarray(heff, jnp.int32)
    ug = jnp.zeros((B, H, 1))
    return jax.jit(solver)(model.params, x0s, ug, cp)


def test_heff_full_matches_unmasked(setup):
    """heff == H everywhere: the masked program is the unmasked one."""
    model, kw, cost, x0s, B = setup
    H = 12
    ref = _solve(model, kw, cost, x0s, H)
    msk = _solve(model, kw, cost, x0s, H, heff=[H] * B)
    np.testing.assert_array_equal(np.asarray(msk[0]), np.asarray(ref[0]))
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(
            np.asarray(msk[i]), np.asarray(ref[i]),
            rtol=1e-9, atol=1e-10, err_msg=str(i),
        )


def test_mixed_heff_matches_dedicated(setup):
    """A mixed-horizon batch at H_max=14: every lane equals the SAME
    lane solved by a dedicated program compiled at its own horizon."""
    model, kw, cost, x0s, B = setup
    H_max = 14
    heff = [5, 8, 11, 14, 7, 9][:B]
    msk = _solve(model, kw, cost, x0s, H_max, heff=heff)
    for lane, h in enumerate(heff):
        cost_l = {k: v[lane:lane + 1] for k, v in cost.items()}
        ded = _solve(model, kw, cost_l, x0s[lane:lane + 1], h)
        assert bool(msk[0][lane]) == bool(ded[0][0]), lane
        np.testing.assert_allclose(
            np.asarray(msk[1][lane, : h + 1]), np.asarray(ded[1][0]),
            rtol=1e-7, atol=1e-9, err_msg=f"xs lane {lane}",
        )
        np.testing.assert_allclose(
            np.asarray(msk[2][lane, :h]), np.asarray(ded[2][0]),
            rtol=1e-7, atol=1e-9, err_msg=f"us lane {lane}",
        )
        np.testing.assert_allclose(
            np.asarray(msk[3][lane, :h]), np.asarray(ded[3][0]),
            rtol=1e-6, atol=1e-8, err_msg=f"Ks lane {lane}",
        )
        # Padded tail: frozen states, pinned (zero-guess) controls.
        tail = np.asarray(msk[1][lane, h + 1:])
        np.testing.assert_allclose(
            tail, np.broadcast_to(np.asarray(msk[1][lane, h]), tail.shape),
            rtol=0, atol=0, err_msg=f"frozen tail lane {lane}",
        )
        np.testing.assert_array_equal(
            np.asarray(msk[2][lane, h:]), 0.0,
        )


def test_horizon_mask_validation():
    b = CartpoleSwingupBenchmark()
    kw = dict(H=8, ds=4, dc=1, obsdim=4, dt=b.system.dt)
    with pytest.raises(ValueError, match="quad_cost_batch"):
        make_batched_ilqr_solver(
            lambda p, x, u: x, None, horizon_mask=True, **kw
        )


def test_horizon_mask_with_compaction(setup):
    """bench_tune's actual configuration: horizon_mask under the
    scheduled compaction driver — the (B,) heff lane rides the cost
    dict through gather/scatter."""
    from autompc_tpu.control.ilqr import make_scheduled_ilqr_solver

    model, kw, cost, x0s, B = setup
    H_max = 14
    heff = [5, 8, 11, 14, 7, 9][:B]
    kw2 = dict(kw)
    kw2.pop("max_iter")
    sched = make_scheduled_ilqr_solver(
        model.pred_core, None, H=H_max, max_iter=8,
        schedule=((2, 0.5),), horizon_mask=True, **kw2
    )
    cp = dict(cost)
    cp["heff"] = jnp.asarray(heff, jnp.int32)
    out_s = jax.jit(sched)(
        model.params, x0s, jnp.zeros((B, H_max, 1)), cp
    )
    ref = _solve(model, kw, cost, x0s, H_max, heff=heff)
    np.testing.assert_array_equal(
        np.asarray(out_s[0]), np.asarray(ref[0])
    )
    np.testing.assert_allclose(
        np.asarray(out_s[2]), np.asarray(ref[2]), rtol=1e-7, atol=1e-9
    )
