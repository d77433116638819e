"""Mesh-parallel candidate evaluation: the accelerator-native tuning fan-out.

No reference counterpart — SMAC evaluates one configuration at a time
(reference: tuning/pipeline_tuner.py:268-271); here a whole batch of
quad-cost candidates is scored as one sharded program.
Run: python examples/4_parallel_tuning.py
(on CPU: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.parallel import QuadCostFanout, make_mesh
from autompc_tpu.sysid import SINDy


def main():
    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80)
    model = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_interaction=True, time_mode="discrete",
    )
    model.train(trajs)

    mesh = make_mesh()
    print("mesh:", mesh)
    fanout = QuadCostFanout(
        benchmark.system, benchmark.task, model, model,
        horizon=20, n_steps=150, mesh=mesh, goal=np.zeros(4),
    )

    B = 32
    rng = np.random.default_rng(0)
    batch = {
        "Qdiag": jnp.asarray(10 ** rng.uniform(-2, 2, (B, 4))),
        "Fdiag": jnp.asarray(10 ** rng.uniform(-2, 2, (B, 4))),
        "Rdiag": jnp.asarray(10 ** rng.uniform(-3, 0, (B, 1))),
    }
    costs = np.asarray(fanout(batch))
    order = np.argsort(costs)
    print("best 5 candidate costs:", costs[order[:5]])
    print("best Qdiag:", np.asarray(batch["Qdiag"])[order[0]])


if __name__ == "__main__":
    main()
