"""Benchmark ABC (reference: autompc/benchmarks/benchmark.py:9-74)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class Benchmark(ABC):
    """Bundles a system, task, ground-truth dynamics, and data generation.

    Addition for compiled rollouts: ``dynamics`` must be a jax-traceable pure
    function so benchmarks can be rolled out inside ``scan``/``vmap``
    (the reference treats dynamics as an arbitrary Python callable)."""

    def __init__(self, name, system, task, data_gen_method):
        self.name = name
        self.system = system
        self.task = task
        self._data_gen_method = data_gen_method

    @abstractmethod
    def dynamics(self, x, u):
        """Ground-truth dynamics: (obs, ctrl) -> next obs. Traceable."""
        raise NotImplementedError

    @abstractmethod
    def gen_trajs(self, seed, n_trajs, traj_len=None):
        """Generate a training set of trajectories."""
        raise NotImplementedError

    def gen_trajs_batch(self, seed, n_trajs, traj_len=None):
        """TrajectoryBatch variant of gen_trajs (device-resident)."""
        from ..core.trajectory import batch

        return batch(self.gen_trajs(seed, n_trajs, traj_len))

    @staticmethod
    @abstractmethod
    def data_gen_methods():
        raise NotImplementedError
