"""JOINT AutoML fan-out: model + cost + controller tuned together,
with a fresh SINDy model trained PER CANDIDATE — fused into one device
program.

This is the reference's flagship workflow (its notebook-0 tune: SMAC
proposes a joint configuration, a sysid model is retrained for every
candidate, then simulated closed-loop — "5 or more hours";
reference: tuning/pipeline_tuner.py:213-258, pipeline.py:107-168).
Here the whole candidate batch — per-lane STLSQ training on the staged
sysid data, per-lane-model per-lane-cost iLQR synthesis at every
closed-loop step, task metric — runs as one sharded program
(parallel/fanout.py:JointSINDyQuadCostFanout).

Run: python examples/8_joint_tuning.py
(on CPU: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import SINDy, SINDyFactory
from autompc_tpu.tuning import PipelineTuner


def main():
    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs(seed=42, n_trajs=60, traj_len=80)

    # Surrogate the candidates are judged against (pretrained here to
    # keep the example fast; modes "autotune"/"autoselect" tune it).
    surrogate = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_interaction=True, time_mode="discrete",
    )
    surrogate.train(trajs)

    # A JOINT pipeline: the model subspace (`_model:threshold`), the
    # cost gains (`_cost:*`), and the controller are tuned together.
    # Fixing the basis configuration keeps every candidate in one
    # compile bucket; leave them free and the tuner buckets per basis.
    pipeline = Pipeline(
        benchmark.system,
        SINDyFactory(
            benchmark.system,
            method="lstsq", time_mode="discrete", poly_basis="false",
            trig_basis="true", trig_freq=1, trig_interaction="true",
        ),
        QuadCostFactory(benchmark.system, goal=np.zeros(4)),
        IterativeLQRFactory(benchmark.system, horizon=10),
    )

    task = benchmark.task.copy()
    task.set_num_steps(60)

    tuner = PipelineTuner(
        surrogate_mode="pretrain",
        eval_batch=16,       # 16 fresh models trained+evaluated per ask
        use_fanout=True,
    )
    kind, reason = tuner._fanout_kind(pipeline, surrogate)
    print(f"fan-out fast path: {kind!r}")

    controller, result = tuner.run(
        pipeline, task, trajs, n_iters=32,
        rng=np.random.default_rng(0), surrogate=surrogate,
    )
    print(f"evaluated {len(result.costs)} joint candidates")
    print(f"incumbent surrogate cost: {result.inc_costs[-1]:.1f}")
    inc = result.inc_cfg
    print(
        "incumbent: threshold=%.2e, Q_theta=%.2f, horizon(fixed)=10"
        % (inc["_model:threshold"], inc["_cost:theta_Q"])
    )


if __name__ == "__main__":
    main()
