"""Joint model+cost+controller fan-out (parallel/fanout.py:
JointSINDyQuadCostFanout).

Parity: the fused batch — per-lane STLSQ training + per-lane-model
per-lane-cost iLQR closed loop — must reproduce the sequential
composition (train SINDy per candidate -> solve -> surrogate rollout ->
task cost) candidate for candidate. This covers the reference's
flagship AutoML scenario (autompc/tuning/pipeline_tuner.py:213-258: a
fresh sysid model per candidate) on the fan-out fast path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control.ilqr import make_ilqr_solver
from autompc_tpu.parallel.fanout import JointSINDyQuadCostFanout
from autompc_tpu.sysid import SINDy

SINDY_CFG = dict(
    method="lstsq", trig_basis=True, trig_freq=1,
    trig_interaction=True, time_mode="discrete",
)


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    all_trajs = b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=60).to_list()
    surr_trajs, sysid_trajs = all_trajs[:30], all_trajs[30:]
    surrogate = SINDy(b.system, threshold=1e-3, **SINDY_CFG)
    surrogate.train(surr_trajs)
    task = b.task.copy()
    task.set_num_steps(11)   # n_steps = 10 closed-loop steps
    return b, task, sysid_trajs, surrogate


def _sequential_cost(b, task, sysid_trajs, surrogate, reg, Qd, Rd, Fd,
                     horizon, n_steps):
    from autompc_tpu.costs import QuadCost

    model = SINDy(b.system, threshold=float(reg), **SINDY_CFG)
    model.train(sysid_trajs)
    cost = QuadCost(
        b.system, jnp.diag(jnp.asarray(Qd)), jnp.diag(jnp.asarray(Rd)),
        jnp.diag(jnp.asarray(Fd)), goal=jnp.zeros(4),
    )
    bounds = task.get_ctrl_bounds()
    solve = jax.jit(make_ilqr_solver(
        model.pred_core, cost, H=horizon, ds=4, dc=1, obsdim=4,
        dt=b.system.dt, ubounds=(bounds[:, 0], bounds[:, 1]),
    ))
    obs = jnp.asarray(task.get_init_obs())
    task_cost = task.get_cost()
    total = 0.0
    ctrl_total = 0.0
    for _ in range(n_steps):
        total += float(task_cost.eval_obs_cost(obs))
        _, xs, us, Ks, ks = solve(model.params, obs, jnp.zeros((horizon, 1)))
        u = us[0]
        ctrl_total += float(task_cost.eval_ctrl_cost(u))
        obs = surrogate.pred_core(surrogate.params, obs, u)[:4]
    total += float(task_cost.eval_obs_cost(obs))
    total += float(task_cost.eval_term_obs_cost(obs))
    return total + ctrl_total


@pytest.mark.slow
def test_joint_fanout_matches_sequential(setup):
    b, task, sysid_trajs, surrogate = setup
    horizon, n_steps = 6, 10
    fanout = JointSINDyQuadCostFanout(
        b.system, task, SINDY_CFG, sysid_trajs, surrogate,
        horizon=horizon, n_steps=n_steps, backward="scan",
    )
    rng = np.random.default_rng(0)
    B = 5
    batch = {
        "reg": jnp.asarray(10.0 ** rng.uniform(-4, -1, B)),
        "Qdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 1, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
    }
    fan_costs = np.asarray(fanout(batch))
    assert fan_costs.shape == (B,)
    for i in range(B):
        seq = _sequential_cost(
            b, task, sysid_trajs, surrogate,
            batch["reg"][i], batch["Qdiag"][i], batch["Rdiag"][i],
            batch["Fdiag"][i], horizon, n_steps,
        )
        np.testing.assert_allclose(
            fan_costs[i], seq, rtol=1e-6,
            err_msg=f"candidate {i}: fanout {fan_costs[i]} vs seq {seq}",
        )


def test_joint_fanout_compaction_and_warmstart_run(setup):
    """The perf configuration (compaction schedule + warm start) returns
    finite costs of the right shape; exactness vs the plain batch is
    covered per-solver in test_batched_ilqr.py."""
    b, task, sysid_trajs, surrogate = setup
    fanout = JointSINDyQuadCostFanout(
        b.system, task, SINDY_CFG, sysid_trajs, surrogate,
        horizon=6, n_steps=8, backward="scan",
        compact_schedule=((6, 0.5),), warm_start=True,
    )
    rng = np.random.default_rng(1)
    B = 3
    batch = {
        "reg": jnp.asarray(10.0 ** rng.uniform(-4, -1, B)),
        "Qdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 1, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
    }
    costs = np.asarray(fanout(batch))
    assert costs.shape == (B,)
    assert np.all(np.isfinite(costs))


def test_joint_fanout_on_mesh(setup):
    """Sharded over the 8-device CPU mesh == unsharded."""
    from autompc_tpu.parallel.mesh import make_mesh

    b, task, sysid_trajs, surrogate = setup
    mesh = make_mesh()
    kw = dict(
        horizon=6, n_steps=8, backward="scan",
    )
    fan_local = JointSINDyQuadCostFanout(
        b.system, task, SINDY_CFG, sysid_trajs, surrogate, **kw
    )
    fan_mesh = JointSINDyQuadCostFanout(
        b.system, task, SINDY_CFG, sysid_trajs, surrogate, mesh=mesh, **kw
    )
    rng = np.random.default_rng(2)
    B = 16
    batch = {
        "reg": jnp.asarray(10.0 ** rng.uniform(-4, -1, B)),
        "Qdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 1, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
    }
    np.testing.assert_allclose(
        np.asarray(fan_mesh(batch)), np.asarray(fan_local(batch)),
        rtol=1e-7,
    )
