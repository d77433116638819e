"""Ranking parity of the warm-started receding loop (GP fan-out lever).

``warm_start=True`` seeds each receding-horizon iLQR solve with the
previous step's shifted control plan instead of zeros. The reference
controller re-solves from a ZERO guess (reference control/ilqr.py:
267-283 — the warm-start branch is commented out there), so warm
starting changes per-candidate closed-loop trajectories slightly; what
the TUNER needs preserved is the candidate ORDERING. This tool scores
one candidate batch through the GP-candidate fan-out with warm start
off and on and reports:

  * top-1 agreement (same incumbent),
  * Spearman rank correlation of the cost vectors,
  * median relative cost difference.

Promotion rule: warm start becomes the gp-mode
default only if top-1 matches and Spearman > 0.95.

Run: python tools/check_warmstart_parity.py       (GPU or CPU)
Env: WSP_B=64 candidates, WSP_M=100 inducing points.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    jax.config.update("jax_compilation_cache_dir", "/root/repo/.jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control.ilqr import parse_schedule
    from autompc_tpu.parallel.fanout import QuadCostFanout
    from autompc_tpu.sysid import SINDy
    from autompc_tpu.sysid.gp import ApproximateGPModel

    B = int(os.environ.get("WSP_B", "64"))
    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    surrogate = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    surrogate.train(trajs)
    gp_model = ApproximateGPModel(
        benchmark.system,
        induce_count=int(os.environ.get("WSP_M", "100")),
    )
    gp_model.train(trajs.to_list())

    compact = parse_schedule(
        os.environ.get("WSP_COMPACT", "8:0.5,16:0.25,28:0.125,40:0.0625")
    )
    rng = np.random.default_rng(7)
    batch = {
        "Qdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
        "Rdiag": jnp.asarray(rng.uniform(1e-3, 1, (B, 1))),
        "Fdiag": jnp.asarray(rng.uniform(0.01, 10, (B, 4))),
    }

    costs = {}
    for warm in (False, True):
        fan = QuadCostFanout(
            benchmark.system, benchmark.task, gp_model, surrogate,
            horizon=10, n_steps=50, goal=np.zeros(4),
            compact_schedule=compact,
            warm_start=warm,
        )
        costs[warm] = np.asarray(fan(batch))

    c0, c1 = costs[False], costs[True]
    finite = np.isfinite(c0) & np.isfinite(c1)
    from scipy.stats import spearmanr

    rho = float(spearmanr(c0[finite], c1[finite]).statistic)
    top1 = bool(np.argmin(np.where(finite, c0, np.inf))
                == np.argmin(np.where(finite, c1, np.inf)))
    relmed = float(np.median(
        np.abs(c1[finite] - c0[finite])
        / np.maximum(np.abs(c0[finite]), 1e-9)
    ))
    out = {
        "metric": "gp_warmstart_rank_parity",
        "top1_match": top1,
        "spearman": round(rho, 4),
        "median_rel_cost_diff": round(relmed, 4),
        "n_finite": int(finite.sum()),
        "B": B,
        "promote": bool(top1 and rho > 0.95),
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
