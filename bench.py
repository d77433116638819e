"""Headline benchmark: full iLQR cartpole solves per second on one GPU.

Measures the BASELINE.json north-star metric: complete iLQR solves
(horizon H=200, the reference's full solver budget: <=50 iterations,
10-alpha line search, tolerance 1e-3; autompc/control/ilqr.py:100-101)
on the cartpole swing-up with a trained SINDy dynamics model, batched
on one card, followed by the closed-loop quality gate.

Prints one JSON line:
    {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N,
     "device": {...}, "quality": {...}}
vs_baseline is value / 1000 (the >=1000 solves/s/chip target; the
reference's own tooling publishes no throughput numbers, BASELINE.md).
``device`` records the platform, device kind and count as JAX reports
them, and the card's name and power limit. The benchmark refuses to run
without a GPU. On the GPU the solver runs the hand-written kernels;
tools/ab_kernels.py measures them against the plain XLA path.

Knobs (env):
    BENCH_BATCH=65536   lanes per batched solve
    BENCH_SCHED=on      device-side converged-lane compaction ("off":
                        one while_loop over the whole batch)
    BENCH_SCHEDULE=...  compaction cut points "iter:frac,..."
    BENCH_REPS=3        timed solves, each on a fresh draw of starts
    BENCH_QUALITY=on    closed-loop quality gate (BENCH_QUALITY_B lanes)
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from autompc_tpu.utils.runtime import device_info, enable_compile_cache

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device['platform']}")
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.sysid import SINDy

    benchmark = CartpoleSwingupBenchmark()
    system = benchmark.system

    # Train the flagship SINDy model (trig library recovers the true
    # cartpole dynamics structure).
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(
        system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    params = model.params

    cost = QuadCost(
        system,
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        0.001 * jnp.eye(1),
        jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
        goal=jnp.zeros(4),
    )

    H = 200
    bounds = benchmark.task.get_ctrl_bounds()
    # 65536 lanes: kept from the earlier accelerator, where it was the
    # largest batch that fit; not yet re-swept on the H100.
    B = int(os.environ.get("BENCH_BATCH", "65536"))
    from autompc_tpu.control.ilqr import (
        make_batched_ilqr_solver,
        make_scheduled_ilqr_solver,
        parse_schedule,
    )

    # The model is linear in its features; the STLSQ fit leaves most
    # coefficient columns exactly zero (7 of 55 features on this
    # model), and the model is fixed for the whole bench, so the static
    # feature mask is sound.
    solver_kw = dict(
        H=H, ds=4, dc=1, obsdim=4, dt=system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]),
        feature_spec=(model.library, "coeffs"),
        feature_mask=tuple(
            int(k) for k in np.flatnonzero(
                np.any(np.abs(np.asarray(model.coeffs)) > 0, axis=0)
            )
        ),
    )
    # Device-side converged-lane compaction: the convergence histogram
    # is long-tailed (median lane ~15 iterations vs the slowest ~50), so
    # the solve shrinks the live batch at static cut points.
    schedule = (
        parse_schedule(os.environ.get(
            "BENCH_SCHEDULE", "8:0.75,15:0.5,22:0.25,30:0.125,40:0.0625"
        ))
        if os.environ.get("BENCH_SCHED", "on") != "off" else None
    )
    if schedule:
        batch_solve = jax.jit(make_scheduled_ilqr_solver(
            model.pred_core, cost, schedule=schedule, **solver_kw
        ))
    else:
        batch_solve = jax.jit(
            make_batched_ilqr_solver(model.pred_core, cost, **solver_kw)
        )

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    )
    uguess = jnp.zeros((B, H, 1))

    # Warmup / compile.
    t0 = time.perf_counter()
    out = batch_solve(params, x0s, uguess)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    print(
        f"[bench] compile+first run: {compile_s:.1f}s (B={B})",
        file=sys.stderr,
    )

    conv = np.asarray(out[0])
    final_theta = np.abs(np.asarray(out[1])[:, -1, 0])
    print(
        f"[bench] quality: {conv.mean() * 100:.1f}% converged, "
        f"median |final theta| {np.median(final_theta):.3f} rad",
        file=sys.stderr,
    )

    # Untimed warm runs, so the timed loop measures steady state.
    for r in range(int(os.environ.get("BENCH_WARM_REPS", "2"))):
        out = batch_solve(params, x0s - 0.01 * (r + 1), uguess)
        jax.block_until_ready(out)

    # Distinct fresh draws per rep: near-identical shifted inputs re-run
    # one draw's convergence histogram, which can sit several percent
    # off the distribution's mean at fixed compaction cuts.
    reps = int(os.environ.get("BENCH_REPS", "3"))
    x0_pool = [
        jnp.asarray(
            rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
        )
        for _ in range(reps)
    ]
    start = time.perf_counter()
    for x0r in x0_pool:
        out = batch_solve(params, x0r, uguess)
        jax.block_until_ready(out)
    elapsed = time.perf_counter() - start
    print(
        f"[bench] {reps} reps in {elapsed:.2f}s "
        f"({elapsed / reps:.3f}s per batched solve)",
        file=sys.stderr,
    )

    solves_per_s = B * reps / elapsed

    # ----- Quality gate -------------------------------------------------
    # The headline counts open-loop solves; a perf "win" that degraded
    # solution quality would still look like a win. Gate it with the
    # receding-horizon closed loop, the deployment shape: 200 MPC steps
    # (H=20, the reference default horizon, recompute every step)
    # against the TRUE cartpole dynamics, one device dispatch for the
    # whole episode batch (control/receding.py). Reported: swing-up
    # success rate (final |theta|,|omega| < the benchmark's 0.2
    # threshold) and mean task cost (the reference ThresholdCost metric:
    # steps with max|obs[0:3] - goal| > 0.2,
    # autompc/costs/thresh_cost.py:27-32, cartpole.py:51).
    quality = {
        "open_loop_converged_frac": round(float(conv.mean()), 4),
        "open_loop_median_final_theta_rad": round(
            float(np.median(final_theta)), 4
        ),
        "compile_first_run_s": round(compile_s, 1),
    }
    if os.environ.get("BENCH_QUALITY", "on") != "off":
        from autompc_tpu.control.receding import make_receding_ilqr_loop

        Bq = int(os.environ.get("BENCH_QUALITY_B", "256"))
        n_steps = 200
        run_cl = jax.jit(
            make_receding_ilqr_loop(
                model.pred_core, cost, benchmark.dynamics,
                H=20, ds=4, dc=1, obsdim=4, dt=system.dt,
                n_steps=n_steps, ubounds=(bounds[:, 0], bounds[:, 1]),
            )
        )
        x0q = jnp.asarray(
            rng.uniform(-1, 1, (Bq, 4)) * np.array([3.1, 1.0, 1.0, 1.0]),
            dtype=x0s.dtype,
        )
        t0 = time.perf_counter()
        xs_cl, us_cl, nconv = run_cl(params, x0q)
        jax.block_until_ready(xs_cl)
        t_cl = time.perf_counter() - t0
        fx = np.asarray(xs_cl)
        success = (np.abs(fx[:, -1, 0]) < 0.2) & (np.abs(fx[:, -1, 1]) < 0.2)
        task_cost = np.sum(
            np.max(np.abs(fx[:, 1:, 0:3]), axis=-1) > 0.2, axis=1
        )
        quality.update(
            closed_loop_success_rate=round(float(success.mean()), 4),
            closed_loop_mean_task_cost=round(float(task_cost.mean()), 2),
            closed_loop_solver_converged_frac=round(
                float(np.asarray(nconv).mean() / n_steps), 4
            ),
            closed_loop_lanes=Bq,
        )
        print(
            f"[bench] closed-loop quality (B={Bq}, 200 MPC steps, "
            f"{t_cl:.1f}s incl. compile): "
            f"{success.mean() * 100:.1f}% swing-up success, "
            f"mean task cost {task_cost.mean():.1f}",
            file=sys.stderr,
        )
        # Hard gate: a perf "win" that degrades closed-loop swing-up
        # success below the floor marks the whole run as failing
        # quality, recorded in the JSON so the regression can't hide,
        # and (BENCH_QUALITY_STRICT=1) a nonzero exit for CI use. The
        # floor 0.85 leaves seed headroom without letting a real
        # regression (a broken acceptance rule reads ~60%) pass.
        gate_min = float(os.environ.get("BENCH_QUALITY_MIN", "0.85"))
        gate_pass = bool(success.mean() >= gate_min)
        quality.update(
            quality_gate_min_success=gate_min,
            quality_gate_pass=gate_pass,
        )
        if not gate_pass:
            print(
                f"[bench] QUALITY GATE FAILED: closed-loop success "
                f"{success.mean() * 100:.1f}% < floor {gate_min * 100:.0f}%",
                file=sys.stderr,
            )
            if os.environ.get("BENCH_QUALITY_STRICT") == "1":
                print(
                    json.dumps(
                        {
                            "metric":
                                "ilqr_cartpole_solves_per_s_per_chip_H200",
                            "value": round(solves_per_s, 2),
                            "unit": "solves/s",
                            "vs_baseline": round(solves_per_s / 1000.0, 3),
                            "device": device,
                            "quality": quality,
                        }
                    )
                )
                sys.exit(2)

    print(
        json.dumps(
            {
                "metric": "ilqr_cartpole_solves_per_s_per_chip_H200",
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / 1000.0, 3),
                "batch": B,
                "device": device,
                "quality": quality,
            }
        )
    )


if __name__ == "__main__":
    main()
