"""Smoke test of the main path on the GPU, through the entry points a
user calls, at the widths the repository benchmarks.

    python chip_smoke.py                # one card: phases 1-6
    python chip_smoke.py --four-cards   # four cards: the sharded paths
    python chip_smoke.py --only headline,kernels   # a subset (debugging)

Phases (one card):

1. device   -- JAX must see a GPU; no CPU fallback.
2. headline -- SINDy trained on the cartpole swing-up as bench.py does;
               the compacting batched iLQR (H=200, <=50 iterations,
               10 alphas) at B=16,384 lanes on the platform's path
               (the kernels); 2,048 lanes compared with vmap of the
               plain single solver at "highest" precision.
3. closed_loop -- 256 lanes x 200 MPC steps against the true cartpole
               dynamics; swing-up success >= 0.85.
4. cheetah  -- halfcheetah MLP batched iLQR (ds=18, dc=6, H=200,
               B=1024; one while_loop, no compaction) on the XLA path;
               every lane compared with the vmapped plain single
               solver as in 2.
5. automl   -- PipelineTuner rounds through the sharded QuadCostFanout
               and JointSINDyQuadCostFanout on a one-card mesh; the
               incumbent must be finite.
6. kernels  -- one phase per hand-written kernel: one solver iteration
               at the headline widths with only that kernel on, against
               the same iteration on the XLA path.

Every phase prints its wall time (compile included) on its own line;
any failure raises and the script exits non-zero without printing the
result line. The last line is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# ---------------------------------------------------------------------
# Comparison helpers (plain numpy; tested on the CPU at small sizes).
# ---------------------------------------------------------------------

# The end-to-end solves are compared by what a user of the solver sees:
# the converged fraction and the mean final objective over lanes both
# runs converged. Lane-for-lane agreement is reported, not required:
# both sides are float32 at "highest" precision but sum in another
# order, and the nonconvex swing-up stops when ||du|| < 1e-3 (which a
# tiny accepted step also satisfies), so a last-bit difference can send
# a lane down another path to another stopping point. On the CPU in
# float32 the backward kernel alone (the same algebra, median relative
# difference 6e-11) moves 4 of 64 lanes by 1-3% at H=12, and the plain
# batched XLA solver moves 2 of 4 halfcheetah lanes against the vmapped
# single solver; in float64 no lane moves. A lane whose path splits
# converges or not by its own odds, so the converged fractions of two
# runs differ like two samples: the tolerance is three standard errors
# of that difference (at least CONV_POINTS points). The kernels
# themselves are held lane for lane in the one-iteration phase
# ([kernels]).
OBJ_RTOL = 1e-4      # reported: share of lanes within this
MEAN_RTOL = 0.02     # mean objective over lanes both converged
CONV_POINTS = 1.0    # floor of the converged-fraction tolerance, points


def quad_objective(xs, us, Qd, Rd, Fd, goal, dt):
    """iLQR objective of diagonal-quadratic costs in float64:
    ``dt * sum_t ((x_t-g)'Q(x_t-g) + u_t'R u_t) + (x_H-g)'F(x_H-g)``.
    xs (B, H+1, n), us (B, H, m); Qd/Fd (n,), Rd (m,)."""
    xs = np.asarray(xs, np.float64)
    us = np.asarray(us, np.float64)
    n = len(Qd)
    dx = xs[:, :-1, :n] - goal
    stage = np.sum(dx * dx * Qd, axis=(1, 2)) + np.sum(us * us * Rd,
                                                       axis=(1, 2))
    dxt = xs[:, -1, :n] - goal
    return dt * stage + np.sum(dxt * dxt * Fd, axis=1)


def compare_solves(obj_a, conv_a, obj_b, conv_b, mean_rtol=MEAN_RTOL,
                   conv_points=CONV_POINTS, rtol=OBJ_RTOL):
    """Compare two batched solves (a against reference b). ``ok`` holds
    when the converged fractions agree within three standard errors of
    their difference (at least ``conv_points`` points), the mean
    objective over lanes both converged agrees within ``mean_rtol``
    (relative), and every converged lane of a is finite. Also reports
    the share of both-converged lanes within ``rtol``."""
    obj_a, obj_b = np.asarray(obj_a, float), np.asarray(obj_b, float)
    conv_a, conv_b = np.asarray(conv_a, bool), np.asarray(conv_b, bool)
    both = conv_a & conv_b
    rel = np.abs(obj_a - obj_b) / np.maximum(np.abs(obj_b), 1e-12)
    frac_a, frac_b = float(conv_a.mean()), float(conv_b.mean())
    conv_tol = max(conv_points / 100.0, 3.0 * np.sqrt(
        (frac_a * (1 - frac_a) + frac_b * (1 - frac_b)) / len(conv_a)))
    mean_rel = 0.0
    if both.any():
        mean_b = float(np.mean(obj_b[both]))
        mean_rel = abs(float(np.mean(obj_a[both])) - mean_b) / max(
            abs(mean_b), 1e-12)
    ok = (
        abs(frac_a - frac_b) <= conv_tol
        and mean_rel <= mean_rtol
        and bool(np.all(np.isfinite(obj_a[conv_a])))
    )
    return dict(
        ok=bool(ok), lanes=int(len(obj_a)), both_converged=int(both.sum()),
        conv_frac_a=frac_a, conv_frac_b=frac_b, conv_tol=float(conv_tol),
        mean_rel=mean_rel,
        share_within_rtol=float(np.mean(rel[both] <= rtol))
        if both.any() else 1.0,
        median_rel=float(np.median(rel[both])) if both.any() else 0.0,
        max_rel=float(np.max(rel[both])) if both.any() else 0.0,
    )


def rel_max_err(a, b):
    """max |a - b| / max |b| (norm-wise relative error)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def swing_up_success(xs):
    """Final |theta| and |omega| both under the benchmark's 0.2."""
    fx = np.asarray(xs)
    return (np.abs(fx[:, -1, 0]) < 0.2) & (np.abs(fx[:, -1, 1]) < 0.2)


# ---------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------


def log(msg):
    print(msg, flush=True)


class Phase:
    """Times one phase; a phase that raises stops the run."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[{self.name}] {status} in {dt:.1f} s")
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args):
    """(result, seconds) with the device work finished."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def cartpole_setup():
    """The headline workload of bench.py: SINDy on the cartpole
    swing-up and its quadratic cost."""
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
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
    Qd = np.array([10.0, 0.1, 0.01, 0.01])
    Rd = np.array([0.001])
    cost = QuadCost(system, jnp.diag(jnp.asarray(Qd)), 0.001 * jnp.eye(1),
                    jnp.diag(jnp.asarray(Qd)), goal=jnp.zeros(4))
    bounds = benchmark.task.get_ctrl_bounds()
    live = np.flatnonzero(np.any(np.abs(np.asarray(model.coeffs)) > 0, 0))
    return dict(
        benchmark=benchmark, system=system, trajs=trajs, model=model,
        cost=cost, Qd=Qd, Rd=Rd,
        ubounds=(bounds[:, 0], bounds[:, 1]),
        feature_mask=tuple(int(k) for k in live),
    )


# Sizes: the headline solve (bench.py's workload at B=16,384), the
# closed-loop gate, the halfcheetah row and the AutoML rounds.
HEADLINE_B = 16384
HEADLINE_H = 200
HEADLINE_REF_LANES = 2048
HEADLINE_SCHEDULE = "8:0.75,15:0.5,22:0.25,30:0.125,40:0.0625"
CL_LANES, CL_STEPS = 256, 200
HC_B, HC_H, HC_REF_LANES = 1024, 200, 1024
AUTOML_ITERS, AUTOML_STEPS = 16, 100
FOUR_B, FOUR_STEPS, FOUR_DT_H = 64, 50, 64


def headline_x0s(B, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
            ).astype(np.float32)


def phase_headline(cp):
    import jax
    import jax.numpy as jnp

    from autompc_tpu.control.ilqr import (
        make_ilqr_solver,
        make_scheduled_ilqr_solver,
        parse_schedule,
    )

    model, H, B = cp["model"], HEADLINE_H, HEADLINE_B
    kw = dict(H=H, ds=4, dc=1, obsdim=4, dt=cp["system"].dt,
              ubounds=cp["ubounds"])
    # The platform's path: on the GPU the hand-written kernels (the
    # model declares itself linear in its features).
    solve = jax.jit(make_scheduled_ilqr_solver(
        model.pred_core, cp["cost"],
        feature_spec=(model.library, "coeffs"),
        feature_mask=cp["feature_mask"],
        schedule=parse_schedule(HEADLINE_SCHEDULE), **kw,
    ))
    x0s = jnp.asarray(headline_x0s(B, 0))
    ug = jnp.zeros((B, H, 1), jnp.float32)
    out, t_first = timed(solve, model.params, x0s, ug)
    _, t_run = timed(solve, model.params, jnp.asarray(headline_x0s(B, 1)),
                     ug)
    conv = np.asarray(out[0])
    log(f"[headline] B={B} H={H}: compile+first run {t_first:.1f} s, "
        f"second run {t_run:.4f} s ({B / t_run:.1f} solves/s), converged "
        f"{conv.mean() * 100:.2f}%")

    n_ref = HEADLINE_REF_LANES
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.vmap(
            make_ilqr_solver(model.pred_core, cp["cost"], backward="scan",
                             **kw),
            in_axes=(None, 0, 0),
        ))
        r_out, t_ref = timed(ref, model.params, x0s[:n_ref], ug[:n_ref])
    obj = quad_objective(np.asarray(out[1])[:n_ref],
                         np.asarray(out[2])[:n_ref], cp["Qd"], cp["Rd"],
                         cp["Qd"], 0.0, kw["dt"])
    obj_r = quad_objective(r_out[1], r_out[2], cp["Qd"], cp["Rd"],
                           cp["Qd"], 0.0, kw["dt"])
    res = compare_solves(obj, conv[:n_ref], obj_r, np.asarray(r_out[0]))
    log(f"[headline] vs vmap(make_ilqr_solver(backward='scan')) at "
        f"'highest' on {n_ref} lanes ({t_ref:.1f} s incl. compile): {res}; "
        f"tolerance: converged fractions within three standard errors "
        f"(at least {CONV_POINTS:g} point), mean objective over lanes "
        f"both converged within {MEAN_RTOL:g} relative")
    check(res["ok"], "headline solve disagrees with the plain reference")
    check(conv.mean() > 0.5, "headline converged fraction below 50%")


def phase_closed_loop(cp):
    import jax
    import jax.numpy as jnp

    from autompc_tpu.control.receding import make_receding_ilqr_loop

    n_lanes, n_steps = CL_LANES, CL_STEPS
    run = jax.jit(make_receding_ilqr_loop(
        cp["model"].pred_core, cp["cost"], cp["benchmark"].dynamics,
        H=20, ds=4, dc=1, obsdim=4, dt=cp["system"].dt,
        n_steps=n_steps, ubounds=cp["ubounds"],
    ))
    x0 = jnp.asarray(headline_x0s(n_lanes, 2))
    (xs, us, nconv), t = timed(run, cp["model"].params, x0)
    success = swing_up_success(xs)
    log(f"[closed_loop] {n_lanes} lanes x {n_steps} MPC steps in {t:.1f} s "
        f"(compile included): swing-up success {success.mean():.4f} "
        f"(gate >= 0.85), solver converged "
        f"{np.asarray(nconv).mean() / n_steps:.4f}")
    check(success.mean() >= 0.85, "closed-loop swing-up below 0.85")


def phase_cheetah():
    import jax
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import HalfcheetahBenchmark
    from autompc_tpu.control.ilqr import (
        make_batched_ilqr_solver,
        make_ilqr_solver,
    )
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.sysid import MLP

    hc = HalfcheetahBenchmark()
    trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    model = MLP(hc.system, n_hidden_layers=2, hidden_size=64,
                n_train_iters=10, n_batch=64)
    model.train(trajs)
    cost = QuadCost(hc.system, jnp.eye(18), jnp.eye(6) * 0.01, jnp.eye(18),
                    goal=jnp.zeros(18))
    bounds = hc.task.get_ctrl_bounds()
    B, H = HC_B, HC_H
    kw = dict(H=H, ds=18, dc=6, obsdim=18, dt=hc.system.dt,
              ubounds=(bounds[:, 0], bounds[:, 1]),
              pred_diff=model.pred_diff_core)
    # One while_loop over the batch: the compacting driver is the
    # headline's; here it would multiply the compile by its 2^4 stages.
    solve = jax.jit(make_batched_ilqr_solver(model.pred_core, cost, **kw))
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 18)), jnp.float32)
    ug = jnp.zeros((B, H, 6), jnp.float32)
    out, t_first = timed(solve, model.params, x0s, ug)
    _, t_run = timed(solve, model.params, x0s + 0.001, ug)
    conv = np.asarray(out[0])
    log(f"[cheetah] B={B} H={H} ds=18 dc=6: compile+first run "
        f"{t_first:.1f} s, second run {t_run:.3f} s ({B / t_run:.1f} "
        f"solves/s), converged {conv.mean() * 100:.2f}%")
    n_ref = HC_REF_LANES
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.vmap(
            make_ilqr_solver(model.pred_core, cost, backward="scan", **kw),
            in_axes=(None, 0, 0),
        ))
        r_out, _ = timed(ref, model.params, x0s[:n_ref], ug[:n_ref])
    ones18, r6 = np.ones(18), np.full(6, 0.01)
    obj = quad_objective(np.asarray(out[1])[:n_ref],
                         np.asarray(out[2])[:n_ref], ones18, r6, ones18,
                         0.0, kw["dt"])
    obj_r = quad_objective(r_out[1], r_out[2], ones18, r6, ones18, 0.0,
                           kw["dt"])
    res = compare_solves(obj, conv[:n_ref], obj_r, np.asarray(r_out[0]))
    log(f"[cheetah] vs vmap(make_ilqr_solver(backward='scan')) at "
        f"'highest' on {n_ref} lanes: {res}; tolerance as in [headline]")
    check(res["ok"], "cheetah solve disagrees with the plain reference")


def phase_automl(cp):
    import jax

    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCostFactory
    from autompc_tpu.parallel import make_mesh
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import SINDyFactory
    from autompc_tpu.tuning import PipelineTuner

    system, model = cp["system"], cp["model"]
    task = cp["benchmark"].task.copy()
    task.set_num_steps(AUTOML_STEPS)
    mesh = make_mesh(n_devices=1)
    pipelines = {
        "fixed SINDy (QuadCostFanout)": model,
        "SINDyFactory (JointSINDyQuadCostFanout)": SINDyFactory(
            system, method="lstsq", time_mode="discrete",
            poly_basis="false", trig_basis="true", trig_freq=1,
            trig_interaction="false",
        ),
    }
    for name, model_or_factory in pipelines.items():
        pipeline = Pipeline(
            system, model_or_factory,
            QuadCostFactory(system, goal=np.zeros(4)),
            IterativeLQRFactory(system, horizon=20),
        )
        tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=8,
                              use_fanout=True, mesh=mesh)
        kind, reason = tuner._fanout_kind(pipeline, model)
        check(kind in ("ilqr", "joint_sindy"),
              f"{name}: no fan-out ({kind}: {reason})")
        t0 = time.perf_counter()
        _, res = tuner.run(pipeline, task, cp["trajs"], n_iters=AUTOML_ITERS,
                           rng=np.random.default_rng(0), surrogate=model)
        costs = np.asarray(res.costs, float)
        best = float(np.min(costs))
        log(f"[automl] {name}: fan-out kind {kind}, {len(costs)} evals in "
            f"{time.perf_counter() - t0:.1f} s (compile included), "
            f"incumbent surrogate cost {best:.4f}, finite "
            f"{np.isfinite(costs).mean():.2f}")
        check(np.isfinite(best), f"{name}: incumbent cost is not finite")
        jax.clear_caches()


def one_iteration(cp, x0s, params=None, **kernel_kw):
    """One iLQR iteration at the headline widths from the same start:
    ``(carry after the iteration as numpy, seconds per iteration)``."""
    import jax
    import jax.numpy as jnp

    from autompc_tpu.control.ilqr import make_batched_ilqr_solver

    model = cp["model"]
    params = model.params if params is None else params
    _, make_carry0, _, make_body = make_batched_ilqr_solver(
        model.pred_core, cp["cost"], H=HEADLINE_H, ds=4, dc=1, obsdim=4,
        dt=cp["system"].dt, ubounds=cp["ubounds"], return_pieces=True,
        **kernel_kw,
    )
    ug = jnp.zeros((x0s.shape[0], HEADLINE_H, 1), x0s.dtype)
    c0 = jax.jit(make_carry0)(params, x0s, ug)
    body = jax.jit(make_body(params))
    timed(body, c0)
    c1, t = timed(body, c0)
    return jax.tree_util.tree_map(np.asarray, c1), t


def lanes_agreeing(us, us_ref, tol=1e-3):
    """Lanes whose accepted controls match the reference's (the same
    step was selected): max |du| <= tol * (1 + max |u_ref|) per lane."""
    du = np.max(np.abs(us - us_ref), axis=(1, 2))
    return du <= tol * (1.0 + np.max(np.abs(us_ref), axis=(1, 2)))


def phase_kernels(cp):
    """Each kernel against the same iteration on the XLA path, both
    held to a float64 run of the XLA path: a kernel passes when it is
    at least as close to float64 as the XLA path in float32 is (within
    a factor 2, floor 1e-6) and selects the float64 step on as many
    lanes (within 0.1 point)."""
    import jax
    import jax.numpy as jnp

    model = cp["model"]
    x0_np = headline_x0s(HEADLINE_B, 3)
    x0s = jnp.asarray(x0_np)
    fs = dict(feature_spec=(model.library, "coeffs"),
              feature_mask=cp["feature_mask"])
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), model.params)
        ref, t_64 = one_iteration(
            cp, jnp.asarray(x0_np, jnp.float64), params=p64,
            backward="scan")
    xla, t_xla = one_iteration(cp, x0s, backward="scan")
    log(f"[kernels] one iteration at B={HEADLINE_B} H={HEADLINE_H}: XLA "
        f"path (scan backward, vmapped scan line search, precision "
        f"'highest') {t_xla * 1e3:.3f} ms; float64 reference run "
        f"{t_64 * 1e3:.3f} ms")

    def within(err_k, err_x):
        return err_k <= 2.0 * err_x + 1e-6

    # Backward kernel alone (the XLA line search follows it).
    bq, t_bq = one_iteration(cp, x0s)
    errs = {k: (rel_max_err(bq[k], ref[k]), rel_max_err(xla[k], ref[k]))
            for k in ("Ks", "ks")}
    log(f"[kernels] ilqr_backward_quad (Pallas, Triton route): one "
        f"iteration {t_bq * 1e3:.3f} ms vs XLA {t_xla * 1e3:.3f} ms; "
        f"rel max err vs float64 (kernel, XLA f32): "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items()))
    check(all(within(a, b) for a, b in errs.values()),
          "backward kernel is further from float64 than the XLA path")

    # Line-search kernel alone (after the XLA backward pass).
    ls, t_ls = one_iteration(cp, x0s, backward="scan", **fs)
    agree_k = lanes_agreeing(ls["us"], ref["us"])
    agree_x = lanes_agreeing(xla["us"], ref["us"])
    m = agree_k & agree_x
    errs = {k: (rel_max_err(ls[k][m], ref[k][m]),
                rel_max_err(xla[k][m], ref[k][m]))
            for k in ("xs", "us", "obj")}
    log(f"[kernels] ilqr_fused_line_search (Pallas, Triton route): one "
        f"iteration {t_ls * 1e3:.3f} ms vs XLA {t_xla * 1e3:.3f} ms; "
        f"float64 step selected on {agree_k.mean():.5f} (kernel) / "
        f"{agree_x.mean():.5f} (XLA f32) of lanes; rel max err vs float64 "
        f"on lanes both selected it (kernel, XLA f32): "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items()))
    check(agree_k.mean() >= agree_x.mean() - 1e-3,
          "line-search kernel selects the float64 step on fewer lanes")
    check(all(within(a, b) for a, b in errs.values()),
          "line-search kernel is further from float64 than the XLA path")

    both, t_both = one_iteration(cp, x0s, **fs)
    log(f"[kernels] both kernels: one iteration {t_both * 1e3:.3f} ms vs "
        f"XLA {t_xla * 1e3:.3f} ms")


def four_cards():
    """The two sharded paths on a 4-card mesh against one card."""
    import jax
    import jax.numpy as jnp

    from autompc_tpu.control.nmpc import make_sqp_solver
    from autompc_tpu.costs import QuadCost
    from autompc_tpu.parallel import QuadCostFanout, make_mesh
    from autompc_tpu.parallel.fanout import JointSINDyQuadCostFanout
    from autompc_tpu.parallel.horizon import make_horizon_sharded_sqp_solver

    n = len(jax.devices())
    check(n >= 4, f"--four-cards needs 4 devices, JAX sees {n}")
    cp = cartpole_setup()
    system, model, benchmark = cp["system"], cp["model"], cp["benchmark"]
    mesh4, mesh1 = make_mesh(n_devices=4), make_mesh(n_devices=1)
    rng = np.random.default_rng(0)
    B = FOUR_B
    batch = {
        "Qdiag": jnp.asarray(rng.uniform(0.5, 5.0, (B, 4)), jnp.float32),
        "Fdiag": jnp.asarray(rng.uniform(0.5, 5.0, (B, 4)), jnp.float32),
        "Rdiag": jnp.asarray(rng.uniform(0.01, 1.0, (B, 1)), jnp.float32),
    }
    jbatch = dict(batch, reg=jnp.asarray(10.0 ** rng.uniform(-4, -1, B),
                                         jnp.float32))
    task = benchmark.task.copy()
    task.set_num_steps(FOUR_STEPS)
    fanouts = {
        "QuadCostFanout": lambda mesh: QuadCostFanout(
            system, task, model, model, horizon=20, mesh=mesh,
            goal=np.zeros(4), feature_spec=(model.library, "coeffs")),
        "JointSINDyQuadCostFanout": lambda mesh: JointSINDyQuadCostFanout(
            system, task,
            dict(method="lstsq", trig_basis=True, trig_freq=1,
                 trig_interaction=False, time_mode="discrete"),
            cp["trajs"].to_list(), model, horizon=20, mesh=mesh,
            goal=np.zeros(4)),
    }
    for name, make in fanouts.items():
        b = jbatch if name.startswith("Joint") else batch
        c4, t4 = timed(make(mesh4), b)
        c1, t1 = timed(make(mesh1), b)
        c4, c1 = np.asarray(c4), np.asarray(c1)
        ok = (np.array_equal(np.isfinite(c4), np.isfinite(c1))
              and np.allclose(c4[np.isfinite(c1)], c1[np.isfinite(c1)],
                              rtol=1e-4, atol=1e-4))
        log(f"[four_cards] {name}: {B} candidates, 4 cards {t4:.1f} s, "
            f"1 card {t1:.1f} s (compile included); max |diff| "
            f"{np.max(np.abs(c4 - c1)[np.isfinite(c1)]):.3e} "
            f"(rtol=1e-4, atol=1e-4); finite {np.isfinite(c4).mean():.2f}")
        check(ok, f"{name}: 4-card costs differ from 1-card costs")

    hz_mesh = make_mesh(n_devices=4, axis_names=("horizon",))
    H = FOUR_DT_H
    quad = QuadCost(system, jnp.eye(4), 0.01 * jnp.eye(1), goal=jnp.zeros(4))
    kw = dict(H=H, ds=4, dc=1, obsdim=4, dt=system.dt,
              ubounds=(jnp.array([-20.0]), jnp.array([20.0])), sqp_iters=4)
    sh = make_horizon_sharded_sqp_solver(model.pred_core, quad,
                                         mesh=hz_mesh, **kw)
    ref = jax.jit(make_sqp_solver(model.pred_core, quad, backward="assoc",
                                  **kw))
    x0 = jnp.array([1.0, 0.0, 0.0, 0.0])
    xs_g = jnp.zeros((H + 1, 4)).at[0].set(x0)
    us_g = jnp.zeros((H, 1))
    (xs_s, us_s), t_s = timed(sh, model.params, x0, xs_g, us_g)
    (xs_r, us_r), t_r = timed(ref, model.params, x0, xs_g, us_g)
    du = float(np.max(np.abs(np.asarray(us_s) - np.asarray(us_r))))
    log(f"[four_cards] horizon-sharded DT (H={H}, 4 shards) {t_s:.1f} s vs "
        f"single-device make_sqp_solver {t_r:.1f} s: max |du| {du:.3e} "
        f"(rtol=1e-4, atol=1e-4)")
    check(np.allclose(np.asarray(us_s), np.asarray(us_r), rtol=1e-4,
                      atol=1e-4),
          "horizon-sharded DT diverged from the single-device SQP")


PHASES = ("headline", "closed_loop", "cheetah", "automl", "kernels")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    with Phase("device"):
        import jax

        from autompc_tpu.utils.runtime import (
            enable_compile_cache,
            gpu_name_and_power_limit,
        )

        devs = jax.devices()
        check(devs[0].platform == "gpu",
              f"JAX found no GPU (platform {devs[0].platform!r})")
        log(f"[device] {len(devs)} x {devs[0].device_kind}; compile cache "
            f"{enable_compile_cache()}")
        log(f"[device] nvidia-smi name, power.limit: "
            f"{gpu_name_and_power_limit()}")
        from autompc_tpu.native import NativeRandomForest

        forest = ("C++ (native/rf.cpp)" if NativeRandomForest.available()
                  else "Python fallback (tuning/bo.py)")
        log(f"[device] BO surrogate forest: {forest}")

    if args.four_cards:
        with Phase("four_cards"):
            four_cards()
    else:
        only = set(args.only.split(","))
        unknown = only - set(PHASES)
        check(not unknown, f"unknown phases {sorted(unknown)}")
        cp = cartpole_setup()
        for name in PHASES:
            if name in only:
                with Phase(name):
                    fn = globals()[f"phase_{name}"]
                    fn() if name == "cheetah" else fn(cp)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    sys.exit(main())
