"""The hand-written kernels compiled for the GPU (no interpret mode)
against the XLA reference. Only a card runs these; here they skip.
``python chip_smoke.py`` runs the same comparisons at the headline
widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the kernels compile for the card only")


def test_backward_kernel_compiled(gpu):
    from test_pallas_riccati import _inputs, _reference

    from autompc_tpu.ops.pallas_riccati import pallas_tvlqr_backward_quad

    a = _inputs(300, 200, 4, 4)
    a = {k: v.astype(jnp.float32) for k, v in a.items()}
    out = pallas_tvlqr_backward_quad(
        a["Jx"], a["Ju"], a["xs"], a["us"], a["Qd"], a["Rd"], a["Fd"],
        a["goal"], 0.05, 4,
    )
    with jax.default_matmul_precision("highest"):
        ref = _reference(a, 0.05, 4)
    for o, r in zip(out, ref):
        scale = float(jnp.max(jnp.abs(r)))
        assert float(jnp.max(jnp.abs(o - r))) <= 1e-3 * scale


def test_solver_kernel_path_compiled(gpu):
    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control.ilqr import make_batched_ilqr_solver
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    model = SINDy(b.system, method="lstsq", threshold=1e-3, trig_basis=True,
                  trig_freq=1, trig_interaction=True, time_mode="discrete")
    model.train(b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60))
    cost = QuadCost(b.system, jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
                    0.001 * jnp.eye(1),
                    jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])))
    bounds = b.task.get_ctrl_bounds()
    kw = dict(H=50, ds=4, dc=1, obsdim=4, dt=b.system.dt,
              ubounds=(bounds[:, 0], bounds[:, 1]))
    B = 512
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-1, 1, (B, 4)), jnp.float32)
    ug = jnp.zeros((B, 50, 1), jnp.float32)
    k = jax.jit(make_batched_ilqr_solver(
        model.pred_core, cost, feature_spec=(model.library, "coeffs"), **kw,
    ))(model.params, x0s, ug)
    x = jax.jit(make_batched_ilqr_solver(
        model.pred_core, cost, backward="scan", **kw,
    ))(model.params, x0s, ug)
    assert abs(float(k[0].mean()) - float(x[0].mean())) < 0.05
    assert bool(jnp.all(jnp.isfinite(k[1])))
