"""Diagnose converged-lane waste in the batched iLQR solve.

Runs the headline bench workload (cartpole swing-up, trained SINDy,
H=200) and prints the per-lane convergence-iteration histogram plus
throughput for the single-program batched solver vs the staged
compacting solver (control/ilqr.py:make_staged_ilqr_solver).

Usage: python tools/measure_ilqr_iters.py [B] [backward] [ls]
"""

import os
import sys
import time

import numpy as np


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    backward = sys.argv[2] if len(sys.argv) > 2 else "auto"
    ls = sys.argv[3] if len(sys.argv) > 3 else "kernel"

    import jax

    jax.config.update("jax_compilation_cache_dir", "/root/repo/.jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control.ilqr import (
        make_batched_ilqr_solver,
        make_staged_ilqr_solver,
    )
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.sysid import SINDy

    benchmark = CartpoleSwingupBenchmark()
    system = benchmark.system
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(
        system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    cost = QuadCost(
        system,
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        0.001 * jnp.eye(1),
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        goal=jnp.zeros(4),
    )
    H = 200
    bounds = benchmark.task.get_ctrl_bounds()
    kw = dict(
        H=H, ds=4, dc=1, obsdim=4, dt=system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]),
        backward=backward,
        feature_spec=(model.library, "coeffs") if ls == "kernel" else None,
    )

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    )
    uguess = jnp.zeros((B, H, 1))

    # --- distribution via the solver pieces -------------------------
    _, make_carry0, cond, make_body = make_batched_ilqr_solver(
        model.pred_core, cost, return_pieces=True, **kw
    )

    @jax.jit
    def full(params, x0s, uguess):
        c = make_carry0(params, x0s, uguess)
        out = jax.lax.while_loop(cond, make_body(params), c)
        return out["done_itr"], out["itr"], out["converged"]

    t0 = time.perf_counter()
    done_itr, itr, conv = jax.block_until_ready(
        full(model.params, x0s, uguess)
    )
    print(f"[diag] pieces compile+run {time.perf_counter() - t0:.1f}s")
    done_itr = np.asarray(done_itr)
    itr = int(itr)
    done_itr = np.where(done_itr == 0, itr, done_itr)  # unfinished lanes
    q = np.percentile(done_itr, [10, 25, 50, 75, 90, 99, 100])
    print(
        f"[diag] done_itr percentiles 10/25/50/75/90/99/max: "
        f"{np.round(q, 1).tolist()}  (while_loop ran {itr} iters, "
        f"{np.mean(conv) * 100:.1f}% converged)"
    )
    waste = 1.0 - done_itr.mean() / itr
    print(
        f"[diag] mean lane-iters {done_itr.mean():.1f} / {itr} -> "
        f"{waste * 100:.1f}% of lane-iteration work wasted; "
        f"ideal compaction speedup {itr / done_itr.mean():.2f}x"
    )

    # --- throughput: batched vs staged -------------------------------
    solve_b = jax.jit(make_batched_ilqr_solver(model.pred_core, cost, **kw))
    out = jax.block_until_ready(solve_b(model.params, x0s, uguess))
    reps = 3
    t0 = time.perf_counter()
    for r in range(reps):
        out = jax.block_until_ready(
            solve_b(model.params, x0s + 0.01 * r, uguess)
        )
    tb = (time.perf_counter() - t0) / reps
    print(f"[diag] batched: {tb:.3f}s/solve -> {B / tb:.0f} solves/s")

    # --- device-side scheduled compaction ----------------------------
    from autompc_tpu.control.ilqr import make_scheduled_ilqr_solver

    solve_c = jax.jit(
        make_scheduled_ilqr_solver(model.pred_core, cost, **kw)
    )
    t0 = time.perf_counter()
    outc = jax.block_until_ready(solve_c(model.params, x0s, uguess))
    print(
        f"[diag] scheduled compile+first run {time.perf_counter() - t0:.1f}s"
    )
    fc = np.asarray(outc[0]).mean()
    print(f"[diag] scheduled converged {fc * 100:.1f}%")
    t0 = time.perf_counter()
    for r in range(reps):
        outc = jax.block_until_ready(
            solve_c(model.params, x0s + 0.01 * r, uguess)
        )
    tc = (time.perf_counter() - t0) / reps
    print(
        f"[diag] scheduled: {tc:.3f}s/solve -> {B / tc:.0f} solves/s "
        f"({tb / tc:.2f}x vs batched)"
    )

    if os.environ.get("SKIP_STAGED"):
        return
    chunk = int(os.environ.get("STAGED_CHUNK", "5"))
    minb = int(os.environ.get("STAGED_MINB", "1024"))
    solve_s = make_staged_ilqr_solver(
        model.pred_core, cost, chunk_iters=chunk, min_bucket=minb, **kw
    )
    t0 = time.perf_counter()
    outs = jax.block_until_ready(solve_s(model.params, x0s, uguess))
    print(f"[diag] staged compile+first run {time.perf_counter() - t0:.1f}s")
    # Bit-exactness across bucket sizes holds on the CPU (tested) but not
    # on the GPU: different batch shapes order reductions differently, so
    # borderline lanes can flip convergence. Compare aggregate quality.
    fb = np.asarray(out[0]).mean()
    fs = np.asarray(outs[0]).mean()
    print(f"[diag] converged: batched {fb * 100:.1f}% staged {fs * 100:.1f}%")
    assert abs(fb - fs) < 0.02
    t0 = time.perf_counter()
    for r in range(reps):
        outs = jax.block_until_ready(
            solve_s(model.params, x0s + 0.01 * r, uguess)
        )
    ts = (time.perf_counter() - t0) / reps
    print(
        f"[diag] staged (chunk={chunk}, min_bucket={minb}): "
        f"{ts:.3f}s/solve -> {B / ts:.0f} solves/s "
        f"({tb / ts:.2f}x vs batched)"
    )


if __name__ == "__main__":
    main()
