"""Trajectory: a pytree of (obs[T, n], ctrls[T, m]) device arrays.

Accelerator-native re-design of the reference ``Trajectory`` (reference:
autompc/trajectory.py:6-201). Differences that matter on an accelerator:

* The arrays are JAX arrays and the object is a registered pytree, so a
  Trajectory (or a stacked batch of them, see :class:`TrajectoryBatch`)
  can flow directly through ``jit`` / ``vmap`` / ``scan``.
* Trajectories are immutable; in-place mutation idioms from the reference
  (``traj[i].obs[:] = y``) become functional updates. Closed-loop rollouts
  build the whole (obs, ctrls) arrays in one ``lax.scan`` instead of
  repeatedly ``extend``-ing (trajectory.py:40-60) — incremental
  concatenation would retrace/reallocate under XLA.
* Variable-length trajectories in a batch are represented with a length
  mask rather than ragged lists, keeping shapes static for the compiler.
"""

from __future__ import annotations

from collections import namedtuple
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .system import System

TimeStep = namedtuple("TimeStep", "obs ctrl")


@jax.tree_util.register_pytree_node_class
class Trajectory:
    """Discrete-time state/control trajectory backed by device arrays."""

    def __init__(self, system: System, size: int, obs, ctrls):
        self._system = system
        self._size = int(size)
        obs = jnp.asarray(obs)
        ctrls = jnp.asarray(ctrls)
        if obs.ndim != 2 or obs.shape[1] != system.obs_dim:
            raise ValueError("obs is wrong shape")
        if ctrls.ndim != 2 or ctrls.shape[1] != system.ctrl_dim:
            raise ValueError("ctrls is wrong shape")
        if obs.shape[0] != self._size or ctrls.shape[0] != self._size:
            raise ValueError("obs/ctrls length does not match size")
        self._obs = obs
        self._ctrls = ctrls

    # -- pytree protocol ----------------------------------------------
    def tree_flatten(self):
        return (self._obs, self._ctrls), (self._system, self._size)

    @classmethod
    def tree_unflatten(cls, aux, children):
        system, size = aux
        obj = object.__new__(cls)
        obj._system = system
        obj._size = size
        obj._obs, obj._ctrls = children
        return obj

    # -- reference-parity API -----------------------------------------
    @property
    def system(self) -> System:
        return self._system

    @property
    def size(self) -> int:
        return self._size

    def __len__(self):
        return self._size

    @property
    def obs(self):
        return self._obs

    @property
    def ctrls(self):
        return self._ctrls

    def __eq__(self, other):
        return (
            isinstance(other, Trajectory)
            and self._system == other._system
            and self._size == other._size
            and bool(jnp.array_equal(self._obs, other._obs))
            and bool(jnp.array_equal(self._ctrls, other._ctrls))
        )

    def __getitem__(self, idx):
        """Label/time indexing, mirroring trajectory.py:113-136:
        ``traj[i]`` -> TimeStep, ``traj[i, "theta"]`` -> value,
        ``traj[a:b]`` -> sub-Trajectory."""
        if isinstance(idx, tuple):
            t, label = idx
            if not isinstance(t, slice) and (t < -self._size or t >= self._size):
                raise IndexError("Time index out of range.")
            if label in self._system.observations:
                return self._obs[t, self._system.obs_index(label)]
            elif label in self._system.controls:
                return self._ctrls[t, self._system.ctrl_index(label)]
            raise IndexError("Unknown label")
        elif isinstance(idx, slice):
            obs = self._obs[idx, :]
            ctrls = self._ctrls[idx, :]
            return Trajectory(self._system, obs.shape[0], obs, ctrls)
        else:
            if idx < -self._size or idx >= self._size:
                raise IndexError("Time index out of range.")
            return TimeStep(self._obs[idx, :], self._ctrls[idx, :])

    # -- functional updates (replace reference __setitem__) ------------
    def replace(self, obs=None, ctrls=None) -> "Trajectory":
        new_obs = self._obs if obs is None else jnp.asarray(obs)
        new_ctrls = self._ctrls if ctrls is None else jnp.asarray(ctrls)
        return Trajectory(self._system, new_obs.shape[0], new_obs, new_ctrls)

    def set_obs(self, t, value) -> "Trajectory":
        return self.replace(obs=self._obs.at[t].set(value))

    def set_ctrl(self, t, value) -> "Trajectory":
        return self.replace(ctrls=self._ctrls.at[t].set(value))

    def __str__(self):
        return f"Trajectory, length={self._size}, system={self._system}"

    __repr__ = __str__

    def numpy(self):
        """Host copies of (obs, ctrls)."""
        return np.asarray(self._obs), np.asarray(self._ctrls)


# -- module-level constructors (reference trajectory.py:6-60) -----------


def zeros(system: System, size: int) -> Trajectory:
    return Trajectory(
        system,
        size,
        jnp.zeros((size, system.obs_dim)),
        jnp.zeros((size, system.ctrl_dim)),
    )


def empty(system: System, size: int) -> Trajectory:
    # XLA has no uninitialized allocation; zeros compile to a cheap fill.
    return zeros(system, size)


def extend(traj: Trajectory, obs, ctrls) -> Trajectory:
    obs = jnp.atleast_2d(jnp.asarray(obs))
    ctrls = jnp.atleast_2d(jnp.asarray(ctrls))
    new_obs = jnp.concatenate([traj.obs, obs])
    new_ctrls = jnp.concatenate([traj.ctrls, ctrls])
    return Trajectory(traj.system, new_obs.shape[0], new_obs, new_ctrls)


def from_arrays(system: System, obs, ctrls) -> Trajectory:
    obs = jnp.asarray(obs)
    return Trajectory(system, obs.shape[0], obs, jnp.asarray(ctrls))


@jax.tree_util.register_pytree_node_class
class TrajectoryBatch:
    """A fixed-shape batch of trajectories: obs[B, T, n], ctrls[B, T, m],
    lengths[B]. The padded tail of shorter trajectories is masked by
    ``lengths``. This replaces the reference's `List[Trajectory]` in every
    device-side code path (training-set assembly, batched metrics, tuning
    rollouts) — ragged Python lists cannot cross the jit boundary."""

    def __init__(self, system: System, obs, ctrls, lengths=None):
        self.system = system
        self.obs = jnp.asarray(obs)
        self.ctrls = jnp.asarray(ctrls)
        if self.obs.ndim != 3 or self.ctrls.ndim != 3:
            raise ValueError("TrajectoryBatch arrays must be rank 3")
        if lengths is None:
            lengths = jnp.full((self.obs.shape[0],), self.obs.shape[1], dtype=jnp.int32)
        self.lengths = jnp.asarray(lengths, dtype=jnp.int32)

    def tree_flatten(self):
        return (self.obs, self.ctrls, self.lengths), (self.system,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.system,) = aux
        obj.obs, obj.ctrls, obj.lengths = children
        return obj

    @property
    def num_trajs(self) -> int:
        return self.obs.shape[0]

    @property
    def max_len(self) -> int:
        return self.obs.shape[1]

    def mask(self):
        """(B, T) validity mask."""
        t = jnp.arange(self.max_len)[None, :]
        return t < self.lengths[:, None]

    def step_mask(self):
        """(B, T) mask of valid *transitions* (t -> t+1)."""
        t = jnp.arange(self.max_len)[None, :]
        return t < (self.lengths[:, None] - 1)

    def __getitem__(self, i) -> Trajectory:
        length = int(self.lengths[i])
        return Trajectory(
            self.system, length, self.obs[i, :length], self.ctrls[i, :length]
        )

    def to_list(self) -> List[Trajectory]:
        return [self[i] for i in range(self.num_trajs)]

    @staticmethod
    def from_trajs(trajs: Sequence[Trajectory], max_len=None) -> "TrajectoryBatch":
        if len(trajs) == 0:
            raise ValueError("Empty trajectory list")
        system = trajs[0].system
        lengths = np.array([t.size for t in trajs], dtype=np.int32)
        T = int(max_len) if max_len is not None else int(lengths.max())
        B = len(trajs)
        obs = np.zeros((B, T, system.obs_dim))
        ctrls = np.zeros((B, T, system.ctrl_dim))
        for i, tr in enumerate(trajs):
            L = min(tr.size, T)
            obs[i, :L] = np.asarray(tr.obs)[:L]
            ctrls[i, :L] = np.asarray(tr.ctrls)[:L]
            if L < T:
                # Pad with the last valid step so padded transitions are
                # fixed points — harmless under the mask, safe without it.
                obs[i, L:] = obs[i, L - 1]
                ctrls[i, L:] = ctrls[i, L - 1]
        return TrajectoryBatch(system, obs, ctrls, np.minimum(lengths, T))


def batch(trajs, max_len=None) -> TrajectoryBatch:
    """Convenience: stack a list of trajectories into a TrajectoryBatch."""
    if isinstance(trajs, TrajectoryBatch):
        return trajs
    return TrajectoryBatch.from_trajs(list(trajs), max_len=max_len)
