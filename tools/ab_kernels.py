"""End-to-end A/B of the hand-written GPU kernels on the headline solve.

The headline workload of bench.py / chip_smoke.py (SINDy cartpole
swing-up, H=200, the compacting batched iLQR at B=16,384) under four
path combinations, each compiled once and then timed in interleaved
rounds on the same fresh draws of starts:

    both                    backward kernel + fused line-search kernel
    backward_kernel_only    backward kernel, XLA line search
    line_search_kernel_only XLA scan backward, fused line-search kernel
    xla                     the plain XLA path (scan backward, vmapped
                            scan line search)

Run on the GPU (one process, one card):

    python tools/ab_kernels.py

Prints one JSON line per combination with the device record.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import jax.numpy as jnp

    from autompc_tpu.control.ilqr import (
        make_scheduled_ilqr_solver,
        parse_schedule,
    )
    from autompc_tpu.utils.runtime import device_info, enable_compile_cache
    from chip_smoke import (
        HEADLINE_B,
        HEADLINE_H,
        HEADLINE_SCHEDULE,
        cartpole_setup,
        headline_x0s,
    )

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"ab_kernels.py measures the GPU; JAX found "
                 f"{device['platform']}")
    cp = cartpole_setup()
    model = cp["model"]
    fs = dict(feature_spec=(model.library, "coeffs"),
              feature_mask=cp["feature_mask"])
    combos = {
        "both": dict(fs),
        "backward_kernel_only": {},
        "line_search_kernel_only": dict(fs, backward="scan"),
        "xla": dict(backward="scan"),
    }
    B, H = HEADLINE_B, HEADLINE_H
    kw = dict(H=H, ds=4, dc=1, obsdim=4, dt=cp["system"].dt,
              ubounds=cp["ubounds"], schedule=parse_schedule(
                  HEADLINE_SCHEDULE))
    ug = jnp.zeros((B, H, 1), jnp.float32)
    solves, rows = {}, {}
    for name, extra in combos.items():
        solves[name] = jax.jit(make_scheduled_ilqr_solver(
            model.pred_core, cp["cost"], **extra, **kw))
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            solves[name](model.params, jnp.asarray(headline_x0s(B, 0)), ug))
        rows[name] = dict(
            compile_first_run_s=time.perf_counter() - t0,
            converged_frac=float(np.asarray(out[0]).mean()), times_s=[],
        )
        print(f"[ab] {name}: compile+first run "
              f"{rows[name]['compile_first_run_s']:.1f} s", file=sys.stderr)
    order = list(combos) + list(reversed(combos))
    for rnd in range(int(os.environ.get("AB_ROUNDS", "2"))):
        x0s = jnp.asarray(headline_x0s(B, 10 + rnd))
        for name in order:
            t0 = time.perf_counter()
            jax.block_until_ready(solves[name](model.params, x0s, ug))
            rows[name]["times_s"].append(time.perf_counter() - t0)
    for name, row in rows.items():
        mean = float(np.mean(row["times_s"]))
        print(json.dumps(dict(
            metric="ilqr_cartpole_solves_per_s_H200", path=name, batch=B,
            value=B / mean, unit="solves/s", mean_solve_s=mean, **row,
            device=device,
        )))


if __name__ == "__main__":
    main()
