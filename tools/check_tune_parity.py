"""Tuning-quality parity: our tuner's incumbents vs the reference's
shipped cached tune.

The reference ships its "5+ hours" 100-iteration SMAC tune result as
assets/cached_tunes/cartpole_tune_result.pkl (loaded by reference
cartpole_v2.py:146-153 / 0_MainDemo.ipynb cell 25). This tool:

1. extracts that pickle's metrics WITHOUT the reference's deps
   (ConfigSpace/SMAC are not installed — a tolerant unpickler stubs
   them; PipelineTuneResult is a namedtuple, reference
   pipeline_tuner.py:19) — the task metric is steps outside the 0.2
   box out of 200 (ThresholdCost, reference cartpole_v2.py);
2. loads OUR cached cartpole tune
   (assets/cached_tunes/cartpole_tune_result.ckpt, fixed-SINDy + quad
   cost + iLQR, 64 fan-out iterations), rebuilds the incumbent
   controller, and simulates it against the true CartpoleSwingupV2
   dynamics — the same metric;
3. prints both side by side + one JSON line.

Run: PYTHONPATH= JAX_PLATFORMS=cpu python tools/check_tune_parity.py
"""

import collections
import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_PKL = "/root/reference/assets/cached_tunes/cartpole_tune_result.pkl"
OURS_CKPT = os.path.join(
    os.path.dirname(__file__), "..", "assets", "cached_tunes",
    "cartpole_tune_result.ckpt",
)

_PTR_FIELDS = [
    "inc_cfg", "cfgs", "inc_cfgs", "costs", "inc_costs",
    "truedyn_costs", "inc_truedyn_costs", "surr_trajs",
    "truedyn_trajs", "surr_tune_result",
]


def load_reference_result():
    """Unpickle the reference tune result with its heavy deps stubbed."""
    sys.path.insert(0, "/root/reference")
    PTR = collections.namedtuple("PipelineTuneResult", _PTR_FIELDS)

    class Stub:
        def __init__(self, *a, **k):
            self._args = a

        def __setstate__(self, state):
            self.__dict__.update(
                state if isinstance(state, dict) else {"_state": state}
            )

    class TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if name == "PipelineTuneResult":
                return PTR
            try:
                return super().find_class(module, name)
            except Exception:
                return type(name, (Stub,), {"_cls": f"{module}.{name}"})

    with open(REF_PKL, "rb") as f:
        return TolerantUnpickler(f).load()


def main():
    ref = load_reference_result()
    ref_stats = dict(
        n_evals=len(ref.cfgs),
        inc_surr_cost=float(ref.inc_costs[-1]),
        inc_truedyn_cost=float(ref.inc_truedyn_costs[-1]),
        truedyn_min=float(np.min(ref.truedyn_costs)),
        costs_median=float(np.median(ref.costs)),
    )
    print(
        f"[reference] {ref_stats['n_evals']} SMAC evals ('5+ hours'): "
        f"incumbent true-dynamics cost "
        f"{ref_stats['inc_truedyn_cost']:.0f}/200 "
        f"(surrogate {ref_stats['inc_surr_cost']:.0f}, population "
        f"median {ref_stats['costs_median']:.0f})",
        flush=True,
    )

    # ---- ours: rebuild + simulate the cached incumbent --------------
    from autompc_tpu.benchmarks import CartpoleSwingupV2Benchmark
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCostFactory
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import SINDy
    from autompc_tpu.utils import simulate
    from autompc_tpu.utils.checkpoint import load_checkpoint

    b = CartpoleSwingupV2Benchmark()
    snap = load_checkpoint(OURS_CKPT)
    trajs = b.gen_trajs(seed=42, n_trajs=40, traj_len=80)
    model = SINDy(
        b.system, method="lstsq", threshold=1e-3, trig_basis=True,
        trig_freq=1, trig_interaction=True, time_mode="discrete",
    )
    model.train(trajs)
    pipeline = Pipeline(
        b.system, model,
        QuadCostFactory(b.system, goal=np.zeros(4)),
        IterativeLQRFactory(b.system),
    )
    space = pipeline.get_configuration_space()
    costs = list(snap["costs"])
    inc_idx = int(np.argmin(costs))
    inc_cfg = space.configuration_from_dict(snap["cfg_dicts"][inc_idx])
    controller, _, _ = pipeline(inc_cfg, b.task.copy(), trajs)
    controller.reset()
    traj = simulate(
        controller, b.task.get_init_obs(), term_cond=b.task.term_cond,
        dynamics=b.dynamics, max_steps=b.task.get_num_steps(),
    )
    # Score with the BENCHMARK's metric (ThresholdCost, steps outside
    # the 0.2 box) — pipeline() returns a task whose cost is the
    # candidate's tuned QuadCost, which is the synthesis objective,
    # not the evaluation metric.
    ours_true = float(b.task.get_cost()(traj))
    ours_stats = dict(
        n_evals=len(costs),
        inc_surr_cost=float(np.min(costs)),
        inc_truedyn_cost=ours_true,
    )
    print(
        f"[ours]      {ours_stats['n_evals']} fan-out evals (cached "
        f"tune, fixed-SINDy pipeline): incumbent true-dynamics cost "
        f"{ours_true:.0f}/200 (surrogate "
        f"{ours_stats['inc_surr_cost']:.0f})",
        flush=True,
    )
    verdict = (
        "OURS_AT_LEAST_AS_GOOD"
        if ours_true <= ref_stats["inc_truedyn_cost"]
        else "REFERENCE_BETTER"
    )
    print(json.dumps({
        "metric": "tune_quality_parity_cartpole",
        "reference": ref_stats,
        "ours": ours_stats,
        "verdict": verdict,
    }))


if __name__ == "__main__":
    main()
