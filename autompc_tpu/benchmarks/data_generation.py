"""Excitation-signal trajectory generators.

Re-creates the reference generators (reference:
autompc/utils/data_generation.py:88-209): uniform-random, PRBS,
random-walk, periodic, and multisine excitation. Re-design for batched devices:

* Control signals are **precomputed as arrays** (they never depend on the
  state), then all trajectories roll through the dynamics as one
  ``vmap(lax.scan)`` — the reference steps each trajectory in a Python
  loop one step at a time.
* Randomness is explicit ``jax.random`` keys (the reference relies on a
  shared numpy Generator), so generation is reproducible under any
  sharding layout.

Each generator returns a list of :class:`Trajectory` (reference parity);
``*_batch`` variants return the underlying :class:`TrajectoryBatch`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.trajectory import Trajectory, TrajectoryBatch


def _as_key(rng):
    if isinstance(rng, jax.Array) and rng.dtype == jax.random.key_impl(
        jax.random.PRNGKey(0)
    ):
        return rng
    if hasattr(rng, "integers"):  # numpy Generator
        return jax.random.PRNGKey(int(rng.integers(1 << 31)))
    return jax.random.PRNGKey(int(rng))


def _rollout_batch(system, dynamics, y0s, Us):
    """Roll B trajectories of length T through ``dynamics`` in one
    vmapped scan. obs[i] is the state *before* applying ctrls[i]
    (reference semantics: data_generation.py:105-112)."""

    def one(y0, U):
        def step(y, u):
            return dynamics(y, u), y

        _, ys = jax.lax.scan(step, y0, U)
        return ys

    obs = jax.jit(jax.vmap(one))(y0s, Us)
    return TrajectoryBatch(system, obs, Us)


def _sample_inits(key, init_min, init_max, n_trajs):
    init_min = jnp.asarray(init_min, dtype=jnp.result_type(float))
    init_max = jnp.asarray(init_max, dtype=jnp.result_type(float))
    u = jax.random.uniform(key, (n_trajs, init_min.shape[0]))
    return init_min + u * (init_max - init_min)


def _finite_ctrl_bounds(task):
    b = task.get_ctrl_bounds()
    umin = np.where(np.isfinite(b[:, 0]), b[:, 0], -1.0)
    umax = np.where(np.isfinite(b[:, 1]), b[:, 1], 1.0)
    return jnp.asarray(umin), jnp.asarray(umax)


def uniform_random_generate_batch(
    system, task, dynamics, rng, init_min, init_max, traj_len, n_trajs
) -> TrajectoryBatch:
    """i.i.d. uniform controls within the task's control bounds
    (data_generation.py:88-104)."""
    key = _as_key(rng)
    k_init, k_u = jax.random.split(key)
    y0s = _sample_inits(k_init, init_min, init_max, n_trajs)
    umin, umax = _finite_ctrl_bounds(task)
    u = jax.random.uniform(k_u, (n_trajs, traj_len, system.ctrl_dim))
    Us = umin + u * (umax - umin)
    return _rollout_batch(system, dynamics, y0s, Us)


def prbs_generate_batch(
    system, task, dynamics, rng, init_min, init_max, traj_len, n_trajs,
    states, Nswitch,
) -> TrajectoryBatch:
    """Pseudo-random binary (multi-level) sequences: hold a randomly chosen
    level between Nswitch random switch times (data_generation.py:106-125)."""
    key = _as_key(rng)
    k_init, k_sw, k_lv = jax.random.split(key, 3)
    y0s = _sample_inits(k_init, init_min, init_max, n_trajs)
    states = jnp.asarray(states, dtype=jnp.result_type(float))
    # Switch times per trajectory; a level is drawn per segment and looked
    # up via searchsorted over time (vectorized equivalent of the
    # reference's per-segment assignment loop).
    switches = jax.random.randint(k_sw, (n_trajs, Nswitch), 0, traj_len)
    switches = jnp.sort(switches, axis=1)
    levels = jax.random.choice(k_lv, states, (n_trajs, Nswitch + 1))

    t = jnp.arange(traj_len)

    def signal(sw, lv):
        seg = jnp.searchsorted(sw, t, side="right")
        return lv[seg]

    Us = jax.vmap(signal)(switches, levels)[..., None]
    if system.ctrl_dim != 1:
        Us = jnp.repeat(Us, system.ctrl_dim, axis=-1)
    return _rollout_batch(system, dynamics, y0s, Us)


def random_walk_generate_batch(
    system, task, dynamics, rng, init_min, init_max, walk_rate, traj_len, n_trajs
) -> TrajectoryBatch:
    """Controls follow a bounded random walk with step scale
    ``walk_rate * dt`` (data_generation.py:127-147)."""
    key = _as_key(rng)
    k_init, k_u0, k_w = jax.random.split(key, 3)
    y0s = _sample_inits(k_init, init_min, init_max, n_trajs)
    umin, umax = _finite_ctrl_bounds(task)
    uamp = jnp.min(jnp.stack([umin, umax]))
    step_size = walk_rate * system.dt
    u0 = umin + jax.random.uniform(k_u0, (n_trajs, system.ctrl_dim)) * (umax - umin)
    dw = uamp * step_size * jax.random.uniform(
        k_w, (n_trajs, traj_len, system.ctrl_dim), minval=-1.0, maxval=1.0
    )
    # Cumulative walk with clipping at each step — a scan, since clip is
    # not prefix-summable.
    def walk(u, d):
        u = jnp.clip(u + d, umin, umax)
        return u, u

    def one(u0_i, dw_i):
        _, us = jax.lax.scan(walk, u0_i, dw_i)
        return us

    Us = jax.vmap(one)(u0, dw)
    return _rollout_batch(system, dynamics, y0s, Us)


def periodic_control_generate_batch(
    system, task, dynamics, rng, init_min, init_max, U_1, traj_len, n_trajs
) -> TrajectoryBatch:
    """Cosine controls, one period per trajectory drawn from an even grid
    (data_generation.py:150-171)."""
    key = _as_key(rng)
    periods = np.array(
        list(range(1, traj_len, max([1, traj_len // n_trajs])))
    )
    B = len(periods)
    y0s = _sample_inits(key, init_min, init_max, B)
    umin, umax = _finite_ctrl_bounds(task)
    uamp = jnp.min(jnp.stack([umin, umax]))
    U_1 = jnp.asarray(U_1, dtype=jnp.result_type(float))
    t = jnp.arange(traj_len, dtype=jnp.result_type(float))
    Us = (
        uamp
        * U_1[None, None, :]
        * jnp.cos(2 * jnp.pi * t[None, :, None] / jnp.asarray(periods, dtype=t.dtype)[:, None, None])
    )
    return _rollout_batch(system, dynamics, y0s, Us)


def multisine_generate_batch(
    system, task, dynamics, rng, init_min, init_max, n_freqs, traj_len, n_trajs
) -> TrajectoryBatch:
    """Sum-of-cosines with Dirichlet-like random weights and random phases
    (data_generation.py:174-209)."""
    key = _as_key(rng)
    k_init, k_w, k_p = jax.random.split(key, 3)
    y0s = _sample_inits(k_init, init_min, init_max, n_trajs)
    umin, umax = _finite_ctrl_bounds(task)
    uamp = (umax - umin) / 2
    umed = (umax + umin) / 2

    periods = jnp.asarray(
        np.array(list(range(1, traj_len, n_freqs))), dtype=jnp.result_type(float)
    )
    P = periods.shape[0]
    # Reference weight scheme: sorted uniform spacings sum to 1
    # (data_generation.py:181-187).
    vals = jax.random.uniform(k_w, (n_trajs, system.ctrl_dim, P - 1))
    vals = jnp.sort(vals, axis=-1)
    vals = jnp.concatenate(
        [jnp.zeros_like(vals[..., :1]), vals, jnp.ones_like(vals[..., :1])], axis=-1
    )
    weights = vals[..., 1:] - vals[..., :-1]  # (B, m, P)
    phases = jax.random.uniform(k_p, (n_trajs, P), maxval=2 * jnp.pi)

    t = jnp.arange(traj_len, dtype=jnp.result_type(float))
    # (B, T, P) cosine table -> weighted sum over P -> (B, T, m)
    angles = 2 * jnp.pi * t[None, :, None] / periods[None, None, :] + phases[:, None, :]
    cos_tab = jnp.cos(angles)
    U = jnp.einsum("btp,bmp->btm", cos_tab, weights)
    Us = uamp[None, None, :] * U + umed[None, None, :]
    return _rollout_batch(system, dynamics, y0s, Us)


def _listify(fn):
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs).to_list()

    wrapper.__name__ = fn.__name__.replace("_batch", "")
    wrapper.__doc__ = fn.__doc__
    return wrapper


uniform_random_generate = _listify(uniform_random_generate_batch)
prbs_generate = _listify(prbs_generate_batch)
random_walk_generate = _listify(random_walk_generate_batch)
periodic_control_generate = _listify(periodic_control_generate_batch)
multisine_generate = _listify(multisine_generate_batch)
