"""Phase profile of the joint-MLP fan-out.

The joint_mlp eval is training-bound by construction, but no phase
split has been measured on the GPU. This times,
at the bench_scaling joint_mlp defaults:

  * the per-lane masked Adam training alone (vmapped train_one),
  * the full eval (training + 50-step closed loop),

so the lever choice (training precision, early stop, lane compaction)
targets the phase that actually dominates.

Run: python tools/profile_mlp_fanout.py   (GPU)
Env: PROF_LANES=1024 PROF_ITERS=50 PROF_STEPS=50
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    jax.config.update("jax_compilation_cache_dir", "/root/repo/.jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.parallel.fanout import JointMLPQuadCostFanout
    from autompc_tpu.sysid import SINDy

    B = int(os.environ.get("PROF_LANES", "1024"))
    iters = int(os.environ.get("PROF_ITERS", "50"))
    n_steps = int(os.environ.get("PROF_STEPS", "50"))

    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    surrogate = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    surrogate.train(trajs)

    fan = JointMLPQuadCostFanout(
        benchmark.system, benchmark.task,
        dict(n_hidden_layers=2, nonlintype="relu"),
        trajs.to_list(), surrogate,
        horizon=10, n_steps=n_steps, goal=np.zeros(4),
        max_width=128, n_train_iters=iters, n_batch=64,
    )

    rng = np.random.default_rng(0)

    def batch_for(seed):
        r = np.random.default_rng(seed)
        widths = tuple(
            (int(r.integers(16, 129)), int(r.integers(16, 129)))
            for _ in range(B)
        )
        return {
            "widths": widths,
            "lr": jnp.asarray(10.0 ** r.uniform(-4, -2, B)),
            "Qdiag": jnp.asarray(r.uniform(0.01, 10, (B, 4))),
            "Rdiag": jnp.asarray(r.uniform(1e-3, 1, (B, 1))),
            "Fdiag": jnp.asarray(r.uniform(0.01, 10, (B, 4))),
        }

    # Full eval timing (the bench_scaling number's shape).
    # PROF_SKIP_FULL=1 jumps straight to the train-only phase (the
    # full-eval program is the long compile).
    K = int(os.environ.get("PROF_REPS", "3"))
    full_s = None
    if os.environ.get("PROF_SKIP_FULL") != "1":
        t0 = time.perf_counter()
        out = fan(batch_for(0))
        _ = float(np.asarray(out)[0])
        print(
            f"[prof] compile+first eval: {time.perf_counter() - t0:.1f}s",
            flush=True,
        )
        t0 = time.perf_counter()
        for j in range(K):
            out = fan(batch_for(j + 1))
        _ = float(np.asarray(out)[0])
        full_s = (time.perf_counter() - t0) / K
        print(
            f"[prof] full eval: {full_s:.2f} s/batch "
            f"({B / full_s:.2f} evals/s)",
            flush=True,
        )

    # Training-only timing: replicate the internal staging through the
    # fan-out's private hooks (the prepared net0/masks batch), timing
    # just the vmapped train_one.
    prep = getattr(fan, "_prepare_batch", None)
    train_fn = getattr(fan, "_train_only", None)
    if train_fn is None:
        print(
            "[prof] fan-out exposes no _train_only hook; add one to "
            "JointMLPQuadCostFanout to split phases",
            flush=True,
        )
        return
    t0 = time.perf_counter()
    nets = train_fn(batch_for(99))
    jax.block_until_ready(nets)
    _ = float(np.asarray(jax.tree_util.tree_leaves(nets)[0]).ravel()[0])
    print(f"[prof] train-only compile+first: {time.perf_counter()-t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    for j in range(K):
        nets = train_fn(batch_for(100 + j))
    _ = float(np.asarray(jax.tree_util.tree_leaves(nets)[0]).ravel()[0])
    train_s = (time.perf_counter() - t0) / K
    frac = (
        f" ({100 * train_s / full_s:.0f}% of the eval)"
        if full_s else ""
    )
    print(
        f"[prof] train only: {train_s:.2f} s/batch"
        f" ({B / train_s:.2f} lanes/s trained){frac}",
        flush=True,
    )


if __name__ == "__main__":
    main()
