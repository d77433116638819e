"""Controller layer: MPC optimizers as scan-compatible step functions.

Re-creates the reference ``Controller``/``ControllerFactory`` contract
(reference: autompc/control/controller.py:6-121) with an
accelerator-native core: every controller exposes a **pure step
function** ``step(cstate, obs) -> (ctrl, cstate)`` over a pytree controller state, so an entire closed-loop
episode runs as one ``lax.scan`` on device (the reference re-enters
``controller.run`` from Python every time step,
utils/simulation.py:52-63). The reference's ``run`` API is kept as a thin
wrapper around the jitted step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import jax


class ControllerFactory(ABC):
    """Creates a controller from a hyperparameter configuration
    (controller.py:15-33 semantics)."""

    def __init__(self, system, **kwargs):
        self.system = system
        self.kwargs = kwargs

    def __call__(self, cfg, task, model):
        controller_kwargs = (
            cfg.get_dictionary() if hasattr(cfg, "get_dictionary") else dict(cfg)
        )
        controller_kwargs.update(self.kwargs)
        return self.Controller(self.system, task, model, **controller_kwargs)

    def get_configuration_space(self):
        raise NotImplementedError


class Controller(ABC):
    def __init__(self, system, task, model):
        self.system = system
        self.task = task
        self.model = model
        self._jit_step = None

    # ------------------------------------------------------------------
    # Functional core
    # ------------------------------------------------------------------
    @abstractmethod
    def step(self, cstate, new_obs):
        """Pure controller step: (cstate pytree, obs[n]) -> (ctrl[m],
        new cstate). Must be jax-traceable; all solver iteration happens
        inside (while_loop/scan), no Python-level state."""
        raise NotImplementedError

    @abstractmethod
    def traj_to_state(self, traj):
        """Initial controller state from a trajectory history."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Reference-parity wrappers
    # ------------------------------------------------------------------
    def run(self, cstate, new_obs):
        """Single jitted controller step (controller.py:76-95 API)."""
        if self._jit_step is None:
            self._jit_step = jax.jit(self.step)
        return self._jit_step(cstate, new_obs)

    def reset(self):
        """Controllers are functionally stateless: warm-start caches live
        in the controller-state pytree, so reset is a no-op kept for API
        parity (controller.py:97-103)."""
        pass

    @property
    @abstractmethod
    def state_dim(self):
        raise NotImplementedError

    @staticmethod
    def is_compatible(system, task, model):
        return True
