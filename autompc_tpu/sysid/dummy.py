"""Test stand-in models (reference: autompc/sysid/dummy_linear.py:9-51,
dummy_nonlinear.py:13-51, linearize.py:5-47)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .model import Model


class DummyLinear(Model):
    """Fixed (A, B) linear model; no training."""

    def __init__(self, system, A, B):
        super().__init__(system)
        self.A = jnp.asarray(A)
        self.B = jnp.asarray(B)

    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    @property
    def state_dim(self):
        return self.system.obs_dim

    def train(self, trajs, silent=False):
        pass

    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def pred_core(self, params, state, ctrl):
        return params["A"] @ state + params["B"] @ ctrl

    def pred_diff(self, state, ctrl):
        return self.pred(state, ctrl), self.A, self.B

    def to_linear(self):
        return self.A, self.B

    def get_parameters(self):
        return {"A": np.array(self.A), "B": np.array(self.B)}

    def set_parameters(self, params):
        self.A = jnp.asarray(params["A"])
        self.B = jnp.asarray(params["B"])


class DummyNonlinear(Model):
    """2-state nonlinear test system (dummy_nonlinear.py:10-12):
    x1' = x1 + x2^3, x2' = x2 + u."""

    def __init__(self, system):
        super().__init__(system)

    @property
    def state_dim(self):
        return 2

    def train(self, trajs, silent=False):
        pass

    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    @property
    def params(self):
        return {}

    def pred_core(self, params, state, ctrl):
        x1, x2 = state[0], state[1]
        return jnp.stack([x1 + x2**3, x2 + ctrl[0]])


class FunctionModel(Model):
    """Wrap an arbitrary jax-traceable dynamics function as a Model — the
    Accelerator-native generalization of the dummy models: lets benchmarks'
    ground-truth dynamics act as a perfect 'trained' model (useful for
    optimizer-isolation tests and oracle baselines)."""

    def __init__(self, system, dynamics_fn):
        super().__init__(system)
        self._fn = dynamics_fn

    @property
    def state_dim(self):
        return self.system.obs_dim

    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    def train(self, trajs, silent=False):
        pass

    @property
    def params(self):
        return {}

    def pred_core(self, params, state, ctrl):
        return self._fn(state, ctrl)


class LinearizedModel(Model):
    """Point linearization of a nonlinear model at ``x0`` with zero
    control (linearize.py:5-47; the reference version's ``pred`` returns
    None — fixed here)."""

    def __init__(self, system, x0, nonlinear_model):
        super().__init__(system)
        self.x0 = jnp.asarray(x0)
        self._model = nonlinear_model
        _, self.A, self.B = nonlinear_model.pred_diff(
            self.x0, jnp.zeros(system.ctrl_dim)
        )

    @property
    def state_dim(self):
        return self._model.state_dim

    def traj_to_state(self, traj):
        return self._model.traj_to_state(traj)

    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def pred_core(self, params, state, ctrl):
        return params["A"] @ state + params["B"] @ ctrl

    def pred_diff(self, state, ctrl):
        return self.pred(state, ctrl), self.A, self.B

    def to_linear(self):
        return self.A, self.B

    def get_parameters(self):
        return {"A": np.array(self.A), "B": np.array(self.B)}

    def set_parameters(self, params):
        self.A = jnp.asarray(params["A"])
        self.B = jnp.asarray(params["B"])
