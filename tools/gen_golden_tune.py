"""Generate the golden GaussReg/SumCost tuning history
(tests/golden/gauss_reg_tune_golden.json).

The per-term GaussReg costs are pinned by unit
tests, but the BO-interaction trajectory (ask/tell sequence, incumbent
progression) was not — a silent change to the tuner's search behavior
would go unnoticed. This pins a complete fixed-seed tune: every
evaluated config's cost, the incumbent cost curve, and the incumbent's
hyperparameter values.

Run on the test environment (CPU, x64 — the same regime
tests/conftest.py uses):

    PYTHONPATH= JAX_PLATFORMS=cpu python tools/gen_golden_tune.py

Regenerate ONLY when the tuner's search behavior changes on purpose;
the test's job is to make that a conscious decision.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLDEN = os.path.join(
    os.path.dirname(__file__), "..", "tests", "golden",
    "gauss_reg_tune_golden.json",
)


def run_tune():
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import (
        GaussRegFactory,
        QuadCostFactory,
        SumCostFactory,
    )
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import SINDy
    from autompc_tpu.tuning import PipelineTuner

    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs(seed=42, n_trajs=40, traj_len=60)
    model = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    cost_factory = SumCostFactory(
        benchmark.system,
        [
            QuadCostFactory(benchmark.system, goal=np.zeros(4)),
            GaussRegFactory(benchmark.system),
        ],
    )
    pipeline = Pipeline(
        benchmark.system,
        model,
        cost_factory,
        IterativeLQRFactory(benchmark.system, horizon=6),
    )
    task = benchmark.task.copy()
    task.set_num_steps(40)
    task.set_init_obs(np.array([0.9, 0.0, 0.0, 0.0]))
    # Quadratic metric cost: the benchmark's 0/1 threshold metric
    # saturates (25.0/40.0 for EVERY candidate at these fixture sizes —
    # cart drift keeps max|obs[0:3]| > 0.2 all episode), which would
    # pin nothing. A quadratic metric discriminates continuously, so
    # the golden history actually constrains the BO trajectory.
    from autompc_tpu.costs import QuadCost

    task.set_cost(QuadCost(
        benchmark.system, np.eye(4), 0.01 * np.eye(1), np.eye(4),
        goal=np.zeros(4),
    ))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=2)
    _, res = tuner.run(
        pipeline, task, trajs, n_iters=6,
        rng=np.random.default_rng(1234), surrogate=model,
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
