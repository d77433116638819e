"""Phase timing for the JOINT AutoML fan-out (SCALE_MODE=joint shape).

On the earlier accelerator the joint throughput was insensitive to the
compaction schedule, so the bottleneck was not converged-lane waste.
This times the joint eval's constituent programs separately:

    train      vmapped per-lane STLSQ/FISTA fit (once per batch)
    solve1     ONE closed-loop step's batched iLQR solve (B lanes)
    surrogate  one surrogate advance of the B lanes
    full       the whole fused eval (train + n_steps closed-loop)

Full ~= train + n_steps * (solve1 + surrogate) when phases dominate;
a large residual means fusion/dispatch effects matter.

Usage (GPU): python tools/profile_joint_fanout.py
Env: PROF_B (512), PROF_H (10), PROF_STEPS (50).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, reps=3):
    import jax

    out = fn(0)
    jax.block_until_ready(out)
    start = time.perf_counter()
    for r in range(reps):
        out = fn(r + 1)  # distinct inputs per rep (memoization guard)
        jax.block_until_ready(out)
    return (time.perf_counter() - start) / reps


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_compilation_cache_dir", "/root/repo/.jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control.ilqr import make_batched_ilqr_solver
    from autompc_tpu.core.trajectory import batch as traj_batch
    from autompc_tpu.ops.lstsq import gram_stage, stlsq_gram
    from autompc_tpu.sysid import SINDy

    B = int(os.environ.get("PROF_B", "512"))
    H = int(os.environ.get("PROF_H", "10"))
    n_steps = int(os.environ.get("PROF_STEPS", "50"))

    benchmark = CartpoleSwingupBenchmark()
    system = benchmark.system
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    surrogate = SINDy(
        system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    surrogate.train(trajs)
    library = surrogate.library
    n, dc = 4, 1

    tb = traj_batch(trajs.to_list())
    feats = library(jnp.concatenate([tb.obs, tb.ctrls], axis=-1))
    targets = jnp.roll(tb.obs, -1, axis=1)
    A_mat = feats.reshape(-1, library.n_features)
    y_mat = targets.reshape(-1, n)
    rmask = tb.step_mask().reshape(-1)

    # Gram-staged training (the production path since stlsq_gram).
    G_mat, b_mat = gram_stage(A_mat, y_mat, mask=rmask)

    def train_one(reg):
        return stlsq_gram(G_mat, b_mat, reg).T

    train_jit = jax.jit(jax.vmap(train_one))

    rng = np.random.default_rng(0)
    regs = jnp.asarray(10 ** rng.uniform(-4, -1, B))

    t_train = timeit(lambda r: train_jit(regs + 1e-9 * r))
    print(f"[joint-phase] train (B={B}):      {t_train * 1e3:9.1f} ms")

    coeffs = train_jit(regs)
    bounds = benchmark.task.get_ctrl_bounds()

    def pred_core(params, state, ctrl):
        return params["coeffs"] @ library(jnp.concatenate([state, ctrl]))

    solve = jax.jit(make_batched_ilqr_solver(
        pred_core, None,
        H=H, ds=n, dc=dc, obsdim=n, dt=system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]),
        feature_spec=(library, "coeffs"),
        batch_params=True, quad_cost_batch=True,
        quad_goal=jnp.zeros(n),
    ))
    cps = {
        "Qdiag": jnp.asarray(10 ** rng.uniform(-1, 1.5, (B, n))),
        "Rdiag": jnp.asarray(10 ** rng.uniform(-3, 0, (B, dc))),
        "Fdiag": jnp.asarray(10 ** rng.uniform(-1, 1.5, (B, n))),
    }
    obs0 = jnp.broadcast_to(
        jnp.asarray(benchmark.task.get_init_obs()), (B, n)
    )
    ug = jnp.zeros((B, H, dc))
    params = {"coeffs": coeffs}

    t_solve = timeit(
        lambda r: solve(params, obs0 + 0.001 * r, ug, cps)
    )
    print(f"[joint-phase] solve1 (one step):  {t_solve * 1e3:9.1f} ms")

    surr_params = surrogate.params
    surr_step = jax.jit(jax.vmap(
        lambda o, u: surrogate.pred_core(surr_params, o, u)[:n]
    ))
    us0 = jnp.zeros((B, dc))
    t_surr = timeit(lambda r: surr_step(obs0 + 0.001 * r, us0))
    print(f"[joint-phase] surrogate step:     {t_surr * 1e3:9.1f} ms")

    # Full fused eval (same shape as JointSINDyQuadCostFanout).
    def eval_batch(reg_b, cps_b):
        cf = jax.vmap(train_one)(reg_b)
        pp = {"coeffs": cf}

        def body(carry, _):
            obs = carry
            _, xs, us, Ks, ks = solve(pp, obs, ug, cps_b)
            u = us[:, 0] + jnp.einsum(
                "bij,bj->bi", Ks[:, 0], obs - xs[:, 0]
            )
            nxt = surr_step(obs, u)
            return nxt, jnp.sum(nxt)

        last, _ = jax.lax.scan(body, obs0, None, length=n_steps)
        return last

    eval_jit = jax.jit(eval_batch)
    t_full = timeit(lambda r: eval_jit(regs + 1e-9 * r, cps), reps=2)
    print(f"[joint-phase] full ({n_steps} steps):   {t_full * 1e3:9.1f} ms")
    print(
        f"[joint-phase] decomposition: train {t_train * 1e3:.0f} + "
        f"{n_steps} * (solve {t_solve * 1e3:.1f} + surr "
        f"{t_surr * 1e3:.1f}) = "
        f"{(t_train + n_steps * (t_solve + t_surr)) * 1e3:.0f} ms "
        f"vs full {t_full * 1e3:.0f} ms"
    )
    print(
        f"[joint-phase] evals/s equivalent: {B / t_full:.1f}"
    )


if __name__ == "__main__":
    main()
