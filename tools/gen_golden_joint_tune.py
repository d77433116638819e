"""Generate the golden JOINT SINDy+QuadCost+iLQR tuning history
(tests/golden/joint_sindy_tune_golden.json).

The flagship joint fan-out (a fresh SINDy model trained per
candidate; reference scenario
autompc/tuning/pipeline_tuner.py:213-258) has fan-out==sequential
parity tests but no pinned end-to-end BO trajectory. Same mechanism as
tools/gen_golden_tune.py: pin every evaluated config's cost, the
incumbent-cost curve, and the incumbent's hyperparameters for a
fixed-seed `PipelineTuner.run` THROUGH the joint_sindy fan-out routing.

Run on the test environment (CPU, x64):

    PYTHONPATH= JAX_PLATFORMS=cpu python tools/gen_golden_joint_tune.py

Regenerate ONLY when the tuner's search behavior changes on purpose.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLDEN = os.path.join(
    os.path.dirname(__file__), "..", "tests", "golden",
    "joint_sindy_tune_golden.json",
)


def run_tune():
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCost, QuadCostFactory
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import SINDy, SINDyFactory
    from autompc_tpu.tuning import PipelineTuner

    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs(seed=42, n_trajs=40, traj_len=60)
    surrogate = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    surrogate.train(trajs)
    pipeline = Pipeline(
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
    task.set_num_steps(40)
    task.set_init_obs(np.array([0.9, 0.0, 0.0, 0.0]))
    # Quadratic metric (same rationale as gen_golden_tune.py: the 0/1
    # threshold metric saturates at these fixture sizes and would pin
    # nothing).
    task.set_cost(QuadCost(
        benchmark.system, np.eye(4), 0.01 * np.eye(1), np.eye(4),
        goal=np.zeros(4),
    ))
    tuner = PipelineTuner(
        surrogate_mode="pretrain", eval_batch=2, use_fanout=True
    )
    kind, reason = tuner._fanout_kind(pipeline, surrogate)
    assert kind == "joint_sindy", (kind, reason)
    _, res = tuner.run(
        pipeline, task, trajs, n_iters=6,
        rng=np.random.default_rng(4321), surrogate=surrogate,
    )
    return res


def main():
    res = run_tune()
    golden = {
        "costs": [float(c) for c in res.costs],
        "inc_costs": [float(c) for c in res.inc_costs],
        "inc_cfg": {k: res.inc_cfg[k] for k in sorted(res.inc_cfg.keys())},
    }
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
    print(f"wrote {GOLDEN}")
    print(json.dumps(golden["inc_costs"]))


if __name__ == "__main__":
    main()
