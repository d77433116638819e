"""Secondary benchmark harness: the non-headline north-star metrics.

- MPPI with 4096 sampled rollouts per control step (BASELINE.json):
  control-step latency and sampled-rollout throughput;
- per-MPC-step latency for iLQR and DirectTranscription vs the
  cartpole real-time budget (dt = 0.05 s).

Prints one JSON line per metric (bench.py remains the single-line
headline harness for the driver).
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
        sys.exit(
            f"bench_extra.py measures the GPU; JAX found {device['platform']}"
        )
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.control import MPPI, DirectTranscriptionController, IterativeLQR
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.sysid import SINDy
    from autompc_tpu.core.trajectory import zeros as traj_zeros

    benchmark = CartpoleSwingupBenchmark()
    system = benchmark.system
    trajs = benchmark.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(
        system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)
    task = benchmark.task.copy()
    task.set_cost(
        QuadCost(
            system,
            jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
            0.001 * jnp.eye(1),
            jnp.diag(jnp.array([10.0, 0.1, 0.01, 0.01])),
            goal=jnp.zeros(4),
        )
    )
    obs = jnp.asarray(benchmark.task.get_init_obs())
    seed_traj = traj_zeros(system, 1)

    def step_latency(controller, reps=20):
        cstate = controller.traj_to_state(seed_traj)
        u, cstate = controller.run(cstate, obs)  # compile
        jax.block_until_ready(u)
        start = time.perf_counter()
        for _ in range(reps):
            u, cstate = controller.run(cstate, obs)
            jax.block_until_ready(u)
        return (time.perf_counter() - start) / reps

    results = []

    # --- MPPI at the 4096-rollout north star -----------------------
    num_path = int(os.environ.get("BENCH_MPPI_PATHS", "4096"))
    mppi = MPPI(
        system, task, model, horizon=20, num_path=num_path,
        sigma=1.0, lmda=0.3,
    )
    lat = step_latency(mppi)
    results.append(
        {
            "metric": "mppi_control_step_latency_ms",
            "num_path": num_path,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )
    results.append(
        {
            "metric": "mppi_sampled_rollouts_per_s",
            "value": round(num_path / lat, 1),
            "unit": "rollouts/s",
        }
    )

    # --- MPPI, DEVICE-RESIDENT closed loop --------------------------
    # As the iLQR device-resident row below: the host loop pays one
    # dispatch and one device->host read per step. One dispatch runs
    # the whole 200-step episode (control/receding.py:
    # make_receding_mppi_loop, host-loop parity-pinned in
    # tests/test_receding.py); per-step cost is honest compute.
    from autompc_tpu.control.receding import make_receding_mppi_loop

    n_steps_cl = 200
    run_mppi_cl = jax.jit(
        make_receding_mppi_loop(
            system, task, model, benchmark.dynamics,
            n_steps=n_steps_cl, horizon=20, num_path=num_path,
            sigma=1.0, lmda=0.3,
        )
    )
    x0_cl1 = jnp.asarray(benchmark.task.get_init_obs())[None, :]
    out = run_mppi_cl(model.params, x0_cl1)  # compile
    jax.block_until_ready(out)
    start = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = run_mppi_cl(model.params, x0_cl1)
        jax.block_until_ready(out)
    lat = (time.perf_counter() - start) / reps / n_steps_cl
    results.append(
        {
            "metric": "mppi_closed_loop_per_step_latency_device_resident_ms",
            "num_path": num_path,
            "mpc_steps_per_dispatch": n_steps_cl,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )
    results.append(
        {
            "metric": "mppi_sampled_rollouts_per_s_device_resident",
            "value": round(num_path / lat, 1),
            "unit": "rollouts/s",
        }
    )

    # --- iLQR per-MPC-step latency ---------------------------------
    ilqr = IterativeLQR(system, task, model, horizon=20)
    lat = step_latency(ilqr, reps=10)
    results.append(
        {
            "metric": "ilqr_control_step_latency_ms",
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )

    # --- iLQR per-MPC-step latency, DEVICE-RESIDENT closed loop -----
    # The host-loop number above includes one dispatch and one
    # device->host read per step. The deployment shape runs the whole
    # episode as one device program (control/receding.py): 200 MPC
    # steps in one dispatch, so per-step cost is compute, the check
    # against the dt=0.05 budget.
    from autompc_tpu.control.receding import make_receding_ilqr_loop

    n_steps = 200
    run_cl = jax.jit(
        make_receding_ilqr_loop(
            model.pred_core, task.get_cost(), benchmark.dynamics,
            H=20, ds=4, dc=1, obsdim=4, dt=system.dt,
            n_steps=n_steps,
            ubounds=(
                task.get_ctrl_bounds()[:, 0], task.get_ctrl_bounds()[:, 1]
            ),
        )
    )
    x0_cl = jnp.asarray(benchmark.task.get_init_obs())[None, :]
    out = run_cl(model.params, x0_cl)  # compile
    jax.block_until_ready(out)
    start = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = run_cl(model.params, x0_cl)
        jax.block_until_ready(out)
    lat = (time.perf_counter() - start) / reps / n_steps
    results.append(
        {
            "metric": "ilqr_closed_loop_per_step_latency_device_resident_ms",
            "mpc_steps_per_dispatch": n_steps,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )

    # --- DirectTranscription per-MPC-step latency ------------------
    dt_con = DirectTranscriptionController(system, task, model, horizon=1)
    lat = step_latency(dt_con, reps=10)
    results.append(
        {
            "metric": "dt_sqp_control_step_latency_ms",
            "knots": dt_con.horizon,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )

    # --- DirectTranscription, DEVICE-RESIDENT closed loop -----------
    # Completes the per-step compute story for all three controller
    # families: warm-started SQP solves in one
    # scan-per-episode dispatch (control/receding.py:
    # make_receding_sqp_loop, host-loop parity-pinned).
    from autompc_tpu.control.receding import make_receding_sqp_loop

    dt_knots = 20
    run_dt_cl = jax.jit(
        make_receding_sqp_loop(
            model.pred_core, task.get_cost(), benchmark.dynamics,
            H=dt_knots, ds=4, dc=1, obsdim=4, dt=system.dt,
            n_steps=n_steps_cl,
            ubounds=(
                task.get_ctrl_bounds()[:, 0], task.get_ctrl_bounds()[:, 1]
            ),
        )
    )
    out = run_dt_cl(model.params, x0_cl1)  # compile
    jax.block_until_ready(out)
    start = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = run_dt_cl(model.params, x0_cl1)
        jax.block_until_ready(out)
    lat = (time.perf_counter() - start) / reps / n_steps_cl
    results.append(
        {
            "metric": "dt_sqp_closed_loop_per_step_latency_device_resident_ms",
            "knots": dt_knots,
            "mpc_steps_per_dispatch": n_steps_cl,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < system.dt,
        }
    )

    # --- halfcheetah-scale MPPI (18 obs / 6 ctrl, MLP model, the
    # true telescoped 200-R cost) ------------------------------------
    from autompc_tpu.benchmarks import HalfcheetahBenchmark
    from autompc_tpu.sysid import MLP

    hc = HalfcheetahBenchmark()
    hc_trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    hc_model = MLP(hc.system, n_hidden_layers=2, hidden_size=64,
                   n_train_iters=10, n_batch=64)
    hc_model.train(hc_trajs)
    hc_paths = int(os.environ.get("BENCH_HC_PATHS", "4096"))
    hc_mppi = MPPI(
        hc.system, hc.task, hc_model, horizon=20, num_path=hc_paths,
        sigma=0.5, lmda=0.5,
    )
    hc_obs = jnp.asarray(hc.task.get_init_obs())
    hc_seed = traj_zeros(hc.system, 1)
    cstate = hc_mppi.traj_to_state(hc_seed)
    u, cstate = hc_mppi.run(cstate, hc_obs)
    jax.block_until_ready(u)
    start = time.perf_counter()
    for _ in range(20):
        u, cstate = hc_mppi.run(cstate, hc_obs)
        jax.block_until_ready(u)
    lat = (time.perf_counter() - start) / 20
    results.append(
        {
            "metric": "halfcheetah_mppi_control_step_latency_ms",
            "num_path": hc_paths,
            "value": round(lat * 1e3, 3),
            "unit": "ms",
            "within_dt_budget": lat < hc.system.dt,
        }
    )

    # --- halfcheetah-scale batched iLQR (ds=18, dc=6, H=200) --------
    # Multi-control solve on the XLA path (dc > 1: no hand-written
    # kernel applies). Reference workload shape:
    # autompc/benchmarks/halfcheetah.py:258-271.
    from autompc_tpu.control.ilqr import make_batched_ilqr_solver

    hc_cost = QuadCost(
        hc.system,
        jnp.eye(18) * 1.0,
        jnp.eye(6) * 0.01,
        jnp.eye(18) * 1.0,
        goal=jnp.zeros(18),
    )
    hc_bounds = hc.task.get_ctrl_bounds()
    hc_B = int(os.environ.get("BENCH_HC_ILQR_B", "1024"))
    hc_H = int(os.environ.get("BENCH_HC_ILQR_H", "200"))
    hc_solver_kw = dict(
        H=hc_H, ds=18, dc=6, obsdim=18, dt=hc.system.dt,
        ubounds=(hc_bounds[:, 0], hc_bounds[:, 1]),
        max_iter=int(os.environ.get("BENCH_HC_ILQR_ITERS", "50")),
        # Closed-form layer-chain Jacobians for the forward/relin
        # phases (sysid/mlp.py:net_apply_jac) instead of jacfwd's 24
        # tangent pushforwards; BENCH_HC_ILQR_JAC=jacfwd compares.
        pred_diff=(
            hc_model.pred_diff_core
            if os.environ.get("BENCH_HC_ILQR_JAC", "analytic") == "analytic"
            else None
        ),
    )
    # Device-side converged-lane compaction: the cheetah convergence
    # histogram is long-tailed (median lane done by iteration 12, tail
    # to 50), so the live batch shrinks at static cuts sized to it. An
    # earlier first cut (10:0.5) trips the overflow branch (the actives
    # don't fit the bucket). BENCH_HC_ILQR_SCHED=off: the plain batch.
    hc_sched_env = os.environ.get(
        "BENCH_HC_ILQR_SCHED", "12:0.5,18:0.25,26:0.125,34:0.0625"
    )
    if hc_sched_env != "off":
        from autompc_tpu.control.ilqr import (
            make_scheduled_ilqr_solver,
            parse_schedule,
        )

        hc_solve = jax.jit(make_scheduled_ilqr_solver(
            hc_model.pred_core, hc_cost,
            schedule=parse_schedule(hc_sched_env), **hc_solver_kw,
        ))
    else:
        hc_solve = jax.jit(make_batched_ilqr_solver(
            hc_model.pred_core, hc_cost, **hc_solver_kw,
        ))
    rng_hc = np.random.default_rng(0)
    hc_x0s = jnp.asarray(
        rng_hc.uniform(-0.1, 0.1, (hc_B, 18)), dtype=jnp.float32
    )
    hc_ug = jnp.zeros((hc_B, hc_H, 6), dtype=jnp.float32)
    start = time.perf_counter()
    out = hc_solve(hc_model.params, hc_x0s, hc_ug)
    jax.block_until_ready(out)
    print(
        f"[bench_extra] cheetah iLQR compile+run: "
        f"{time.perf_counter() - start:.1f}s (B={hc_B})",
        file=sys.stderr,
    )
    # timeit_distinct discipline (utils/profiling.py): distinct inputs
    # per rep, first rep excluded as warmup.
    from autompc_tpu.utils.profiling import timeit_distinct

    reps = int(os.environ.get("BENCH_HC_ILQR_REPS", "4"))
    hc_inputs = [
        (hc_model.params, hc_x0s + 0.001 * (r + 1), hc_ug)
        for r in range(reps + 1)
    ]
    lat, out = timeit_distinct(hc_solve, hc_inputs, silent=True)
    results.append(
        {
            "metric": "halfcheetah_ilqr_solves_per_s_per_chip",
            "ds": 18, "dc": 6, "H": hc_H, "batch": hc_B,
            "compact_schedule": hc_sched_env,
            "converged_frac": round(
                float(np.asarray(out[0]).mean()), 3
            ),
            "value": round(hc_B / lat, 2),
            "unit": "solves/s",
        }
    )

    # --- model-tuning throughput: bucketed ARX candidate scoring ----
    # (replaces SMAC's one-candidate-at-a-time model tuner; every
    # history candidate trains + scores in one device program,
    # tuning/bucketed.py)
    from autompc_tpu.tuning.bucketed import ARXBucketEvaluator

    tl = trajs.to_list()
    arx_eval = ARXBucketEvaluator(
        system, tl[:40], tl[40:], kmax=10, horizon=5
    )
    ks = list(range(1, 11))
    arx_eval(ks)  # compile
    start = time.perf_counter()
    reps = 10
    for _ in range(reps):
        arx_eval(ks)
    lat = (time.perf_counter() - start) / reps
    results.append(
        {
            "metric": "arx_bucket_train_and_score_configs_per_s",
            "value": round(len(ks) / lat, 1),
            "unit": "configs/s",
        }
    )

    # --- SVGP surrogate: train + batched prediction ------------------
    # (the reference delegates this to GPyTorch+CUDA, largegp.py)
    from autompc_tpu.sysid import ApproximateGPModel

    gp = ApproximateGPModel(
        system, niter=5, induce_count=64, batch_size=256, seed=0
    )
    start = time.perf_counter()
    gp.train(tl[:40])
    t_train = time.perf_counter() - start
    xs = jnp.asarray(
        np.random.default_rng(0).uniform(-1, 1, (4096, system.obs_dim))
    )
    us = jnp.zeros((4096, system.ctrl_dim))
    preds = gp.pred_batch(xs, us)  # compile
    jax.block_until_ready(preds)
    start = time.perf_counter()
    for _ in range(10):
        preds = gp.pred_batch(xs, us)
        jax.block_until_ready(preds)
    lat = (time.perf_counter() - start) / 10
    results.append(
        {
            "metric": "svgp_train_s_and_pred_throughput",
            "train_s": round(t_train, 2),
            "value": round(4096 / lat, 1),
            "unit": "preds/s",
        }
    )

    for r in results:
        print(json.dumps(dict(r, device=device)))


if __name__ == "__main__":
    main()
