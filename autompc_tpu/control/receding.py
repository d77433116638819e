"""Device-resident receding-horizon MPC loop.

The reference runs MPC as a host loop — one ``controller.run`` call per
plant step, re-entering Python between steps
(autompc/utils/simulation.py:52-63, autompc/control/ilqr.py:267-295).
On an accelerator that shape is dispatch-bound: each step pays a
dispatch and a device->host read, which both dwarf the per-step compute
and hide it from measurement.

``make_receding_ilqr_loop`` instead compiles the WHOLE closed loop —
N plant steps, each containing a full iLQR solve — into one device
program (``lax.scan`` over steps, ``lax.while_loop`` inside the solve),
vmapped over a lane batch. This is simultaneously:

* the deployment shape (one dispatch per episode, not per step);
* the honest latency measurement (per-step cost = episode time / N,
  with the per-dispatch overhead amortized away);
* the quality gate for the headline bench (closed-loop swing-up
  success rate + task cost can't silently degrade under kernel work).

Semantics per step mirror the reference controller's default path
(reuse_feedback=0, recompute every step, ilqr.py:267-295): solve from
the current plant state, apply ``us[0]`` (the reference's
``u0 + K0 @ (state - x0)`` with ``x0 == state`` exactly), advance the
true plant. ``warm_start=True`` seeds each solve with the previous
solution shifted one step (the reference uses a zero guess every
recompute; warm starting is the deployment norm — its DT controller
warm-starts the same way, nmpc.py:320-325 — and is the default here;
set False for step-exact reference parity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ilqr import make_ilqr_solver


def make_receding_ilqr_loop(
    pred_core,
    cost,
    plant_step,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    n_steps: int,
    ubounds=None,
    warm_start: bool = True,
    max_iter: int = 50,
    **solver_kw,
):
    """Build ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds),
    us (B, n_steps, dc), n_converged (B,))``.

    ``pred_core(params, x, u)`` is the controller's (learned) model;
    ``plant_step(x, u)`` is the true dynamics the loop rolls forward —
    the surrogate-vs-truth split of the reference's ``simulate``
    (utils/simulation.py:54-58). ``n_converged`` counts plant steps
    whose inner solve reported convergence (a solver-health signal for
    the bench quality gate).
    """
    solve = make_ilqr_solver(
        pred_core,
        cost,
        H=H,
        ds=ds,
        dc=dc,
        obsdim=obsdim,
        dt=dt,
        ubounds=ubounds,
        max_iter=max_iter,
        **solver_kw,
    )

    def run_one(params, x0):
        def step(carry, _):
            x, uguess = carry
            converged, xs, us, Ks, ks = solve(params, x, uguess)
            u = us[0]
            x1 = plant_step(x, u)
            next_guess = (
                jnp.concatenate([us[1:], jnp.zeros((1, dc), us.dtype)])
                if warm_start
                else jnp.zeros((H, dc), us.dtype)
            )
            return (x1, next_guess), (x1, u, converged)

        (xT, _), (xs1, us, conv) = jax.lax.scan(
            step, (x0, jnp.zeros((H, dc), x0.dtype)), None, length=n_steps
        )
        xs = jnp.concatenate([x0[None], xs1], axis=0)
        return xs, us, jnp.sum(conv.astype(jnp.int32))

    def run(params, x0s):
        return jax.vmap(lambda x0: run_one(params, x0))(x0s)

    return run


def make_receding_mppi_loop(
    system,
    task,
    model,
    plant_step,
    n_steps: int,
    seed: int = 0,
    **mppi_kwargs,
):
    """Device-resident receding-horizon MPPI: the WHOLE episode — N
    plant steps, each a full sampled-rollout MPPI update — compiles
    into one ``lax.scan`` program, vmapped over a lane batch.

    Returns ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds),
    us (B, n_steps, dc))``. Per-step semantics are exactly
    ``MPPI.step`` (control/mppi.py:203-220; reference mppi.py:154-168):
    shift the nominal sequence, draw ``num_path`` perturbations, batch-
    roll through the model, exponential-weight update, apply the first
    control, advance the true plant. Each lane consumes its own PRNG
    chain (``fold_in(lane)``), so lanes are independent episodes.

    The reference's ``simulate`` host loop re-enters Python per step
    (utils/simulation.py:52-63) and pays a dispatch per step, so a
    host-loop latency reads as a dispatch floor, not compute. This is
    the honest deployment shape (one dispatch per episode).
    """
    from .mppi import MPPI

    mppi = MPPI(system, task, model, **mppi_kwargs)
    H, dc = mppi.H, mppi.dim_ctrl
    ds = model.state_dim

    def run_one(params, x0, key):
        key, k0 = jax.random.split(key)
        seq0 = jnp.sqrt(mppi.sigma) * jax.random.normal(k0, (H, dc))

        def step(carry, _):
            x, seq, key = carry
            for _ in range(mppi.niter):
                seq = jnp.concatenate([seq[1:], seq[-1:]], axis=0)
                key, k_noise = jax.random.split(key)
                costs, eps = mppi._do_rollouts(params, x, seq, k_noise)
                seq = mppi._update_sequence(seq, costs, eps)
            u = seq[0] * mppi._ctrl_scale
            x1 = plant_step(x, u)
            return (x1, seq, key), (x1, u)

        (xT, _, _), (xs1, us) = jax.lax.scan(
            step, (x0, seq0, key), None, length=n_steps
        )
        return jnp.concatenate([x0[None], xs1], axis=0), us

    def run(params, x0s):
        keys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i)
        )(jnp.arange(x0s.shape[0]))
        return jax.vmap(lambda x0, k: run_one(params, x0, k))(x0s, keys)

    return run


def make_receding_sqp_loop(
    pred_core,
    cost,
    plant_step,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    n_steps: int,
    ubounds=None,
    warm_start: bool = True,
    **solver_kw,
):
    """Device-resident receding-horizon direct transcription: N plant
    steps, each a full warm-started SQP solve (control/nmpc.py:
    make_sqp_solver), in one ``lax.scan`` program vmapped over lanes.

    Returns ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds),
    us (B, n_steps, dc))``. Per-step semantics mirror
    ``DirectTranscriptionController.run`` (reference nmpc.py:313-325):
    solve the knot-point NLP from the current state, apply ``u_0``,
    warm-start the next solve from the previous solution shifted one
    knot (nmpc.py:320-325's sol caching; ``warm_start=False`` re-seeds
    a zero guess each step for host-loop parity tests).
    """
    from .nmpc import make_sqp_solver

    solve = make_sqp_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, **solver_kw,
    )

    def run_one(params, x0):
        def step(carry, _):
            x, xs_g, us_g = carry
            xs, us = solve(params, x, xs_g.at[0].set(x), us_g)
            u = us[0]
            x1 = plant_step(x, u)
            if warm_start:
                xs_next = jnp.concatenate([xs[1:], xs[-1:]], axis=0)
                us_next = jnp.concatenate([us[1:], us[-1:]], axis=0)
            else:
                xs_next = jnp.zeros_like(xs_g)
                us_next = jnp.zeros_like(us_g)
            return (x1, xs_next, us_next), (x1, u)

        xs_g0 = jnp.zeros((H + 1, ds), x0.dtype)
        us_g0 = jnp.zeros((H, dc), x0.dtype)
        (xT, _, _), (xs1, us) = jax.lax.scan(
            step, (x0, xs_g0, us_g0), None, length=n_steps
        )
        return jnp.concatenate([x0[None], xs1], axis=0), us

    def run(params, x0s):
        return jax.vmap(lambda x0: run_one(params, x0))(x0s)

    return run
