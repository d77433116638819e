"""Model layer: system-ID models as (static config, parameter pytree,
pure step function).

Re-creates the reference ``Model``/``ModelFactory`` contract (reference:
autompc/sysid/model.py:8-244) with an accelerator-native functional core:

* Every model separates **static configuration** (shapes: history length,
  basis count, layer widths — attributes of the object) from **trained
  parameters** (a pytree of arrays, ``model.params``).
* ``pred`` is derived from one pure function
  ``pred_core(params, state, ctrl) -> state``; batching comes from
  ``jax.vmap`` (replacing every hand-rolled ``pred_batch``,
  model.py:109-131) and Jacobians from ``jax.jacfwd`` (replacing the
  hand-written ``pred_diff`` implementations, e.g. mlp.py:232-305).
* Controllers and the tuner grab ``(model.params, model.pred_core)`` and
  fuse prediction into their own jitted programs; the OO methods here are
  conveniences that wrap the same pure function.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from functools import partial

import jax
import jax.numpy as jnp


class ModelFactory(ABC):
    """Creates and trains a system-ID model from a hyperparameter
    configuration (reference semantics: model.py:23-46)."""

    def __init__(self, system, **kwargs):
        self.system = system
        self.kwargs = kwargs

    def __call__(self, cfg, train_trajs, silent=False, skip_train_model=False):
        model_args = cfg.get_dictionary() if hasattr(cfg, "get_dictionary") else dict(cfg)
        model_args.update(self.kwargs)
        model = self.Model(self.system, **model_args)
        model.factory = self
        if not skip_train_model:
            model.train(train_trajs, silent=silent)
        return model

    @abstractmethod
    def get_configuration_space(self):
        raise NotImplementedError


class Model(ABC):
    def __init__(self, system):
        self.system = system

    # ------------------------------------------------------------------
    # Functional core — concrete models implement these.
    # ------------------------------------------------------------------
    @property
    def params(self):
        """Pytree of trained parameters. Default: the get_parameters dict."""
        return self.get_parameters()

    def pred_core(self, params, state, ctrl):
        """Pure single-step prediction: (params, state[ds], ctrl[dc]) ->
        state[ds]. Must be jax-traceable with no data-dependent Python
        control flow. Concrete models override this; everything else
        (pred/pred_batch/pred_diff/...) derives from it."""
        raise NotImplementedError

    def update_state_core(self, params, state, new_ctrl, new_obs):
        """Pure model-state update on new measurement. Default: models
        whose state is the observation just adopt the new observation."""
        del params, state, new_ctrl
        return jnp.asarray(new_obs)

    # ------------------------------------------------------------------
    # Derived reference-parity API (model.py:62-244)
    # ------------------------------------------------------------------
    @abstractmethod
    def traj_to_state(self, traj):
        """Map a trajectory history to the current model state."""
        raise NotImplementedError

    def state_to_obs(self, state):
        """Observation part of a model state (reference arx.py:105-107,
        largegp.py:69-70). Default: the leading obs_dim entries."""
        return state[: self.system.obs_dim]

    def update_state(self, state, new_ctrl, new_obs):
        return self.update_state_core(
            self.params, jnp.asarray(state), jnp.asarray(new_ctrl), jnp.asarray(new_obs)
        )

    def pred(self, state, ctrl):
        return self.pred_core(self.params, jnp.asarray(state), jnp.asarray(ctrl))

    def pred_batch(self, states, ctrls):
        return jax.vmap(partial(self.pred_core, self.params))(
            jnp.asarray(states), jnp.asarray(ctrls)
        )

    def pred_diff(self, state, ctrl):
        state = jnp.asarray(state)
        ctrl = jnp.asarray(ctrl)
        params = self.params
        pred = self.pred_core(params, state, ctrl)
        jac_x = jax.jacfwd(lambda s: self.pred_core(params, s, ctrl))(state)
        jac_u = jax.jacfwd(lambda u: self.pred_core(params, state, u))(ctrl)
        return pred, jac_x, jac_u

    def pred_diff_batch(self, states, ctrls):
        states = jnp.asarray(states)
        ctrls = jnp.asarray(ctrls)
        params = self.params

        def one(s, u):
            pred = self.pred_core(params, s, u)
            jx = jax.jacfwd(lambda ss: self.pred_core(params, ss, u))(s)
            ju = jax.jacfwd(lambda uu: self.pred_core(params, s, uu))(u)
            return pred, jx, ju

        return jax.vmap(one)(states, ctrls)

    def to_linear(self):
        """(A, B) for linear models only."""
        raise NotImplementedError

    def train(self, trajs, silent=False):
        raise NotImplementedError

    def get_parameters(self):
        raise NotImplementedError

    def set_parameters(self, params):
        raise NotImplementedError

    @property
    @abstractmethod
    def state_dim(self):
        raise NotImplementedError

    @property
    def is_linear(self):
        return type(self).to_linear is not Model.to_linear

    @property
    def is_diff(self):
        # All models with a traceable pred_core are differentiable via
        # jacfwd; models may override to opt out.
        return type(self).pred_core is not Model.pred_core
