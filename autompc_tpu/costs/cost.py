"""Cost layer: pure, traceable cost functions with autodiff derivatives.

Re-creates the reference ``Cost`` ABC (reference: autompc/costs/cost.py:
7-255) with the same public API (``eval_obs_cost{,_diff,_hess}``,
``eval_ctrl_cost{,_diff,_hess}``, ``eval_term_obs_cost{,_diff,_hess}``,
``get_cost_matrices``, ``get_goal``, capability flags, ``+`` algebra), but
Accelerator-native:

* Every ``eval_*`` method is a **pure jax-traceable function** of a jnp
  array, usable inside ``jit`` / ``vmap`` / ``scan`` (the reference's
  NumPy methods are re-entered from Python once per knot point per solver
  iteration — here a whole horizon's costs evaluate as one fused kernel).
* Derivative fallbacks come from ``jax.grad`` / ``jax.hessian`` instead of
  hand-written Jacobians; quadratic costs keep closed forms.
* ``__call__(traj)`` evaluates the whole trajectory with one vectorized
  reduction (reference loops in Python, cost.py:27-41).

Divergence from the reference, on purpose: the reference's
``eval_term_obs_cost_diff/_hess`` drop the goal offset for the quadratic
fast path (cost.py:194-212 uses ``obs`` where stage costs use
``obs - goal``, cost.py:179-182). We implement the mathematically correct
``obs - goal`` form everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class Cost:
    """Base class for cost functions."""

    def __init__(self, system):
        self.system = system
        self._is_quad = False
        self._is_convex = False
        self._is_diff = False
        self._is_twice_diff = False
        self._has_goal = False
        self._Q = None
        self._R = None
        self._F = None
        self._goal = None

    # ------------------------------------------------------------------
    # Whole-trajectory evaluation (vectorized; cost.py:27-41 semantics:
    # sum of per-step obs+ctrl costs over all steps, plus terminal cost
    # at the final observation).
    # ------------------------------------------------------------------
    def __call__(self, traj):
        obs, ctrls = traj.obs, traj.ctrls
        total = jnp.sum(jax.vmap(self.eval_obs_cost)(obs))
        total = total + jnp.sum(jax.vmap(self.eval_ctrl_cost)(ctrls))
        total = total + self.eval_term_obs_cost(obs[-1])
        return total

    # ------------------------------------------------------------------
    # Quadratic fast paths + autodiff fallbacks
    # ------------------------------------------------------------------
    def eval_obs_cost(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return obst @ self._Q @ obst
        raise NotImplementedError

    def eval_obs_cost_diff(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return obst @ self._Q @ obst, (self._Q + self._Q.T) @ obst
        if self.is_diff:
            return self.eval_obs_cost(obs), jax.grad(self.eval_obs_cost)(obs)
        raise NotImplementedError

    def eval_obs_cost_hess(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return (
                obst @ self._Q @ obst,
                (self._Q + self._Q.T) @ obst,
                self._Q + self._Q.T,
            )
        if self.is_twice_diff:
            c, g = self.eval_obs_cost_diff(obs)
            return c, g, jax.hessian(self.eval_obs_cost)(obs)
        raise NotImplementedError

    def eval_ctrl_cost(self, ctrl):
        if self.is_quad:
            return ctrl @ self._R @ ctrl
        raise NotImplementedError

    def eval_ctrl_cost_diff(self, ctrl):
        if self.is_quad:
            return ctrl @ self._R @ ctrl, (self._R + self._R.T) @ ctrl
        if self.is_diff:
            return self.eval_ctrl_cost(ctrl), jax.grad(self.eval_ctrl_cost)(ctrl)
        raise NotImplementedError

    def eval_ctrl_cost_hess(self, ctrl):
        if self.is_quad:
            return (
                ctrl @ self._R @ ctrl,
                (self._R + self._R.T) @ ctrl,
                self._R + self._R.T,
            )
        if self.is_twice_diff:
            c, g = self.eval_ctrl_cost_diff(ctrl)
            return c, g, jax.hessian(self.eval_ctrl_cost)(ctrl)
        raise NotImplementedError

    def eval_term_obs_cost(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return obst @ self._F @ obst
        raise NotImplementedError

    def eval_term_obs_cost_diff(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return obst @ self._F @ obst, (self._F + self._F.T) @ obst
        if self.is_diff:
            return (
                self.eval_term_obs_cost(obs),
                jax.grad(self.eval_term_obs_cost)(obs),
            )
        raise NotImplementedError

    def eval_term_obs_cost_hess(self, obs):
        if self.is_quad:
            obst = obs - self._goal
            return (
                obst @ self._F @ obst,
                (self._F + self._F.T) @ obst,
                self._F + self._F.T,
            )
        if self.is_twice_diff:
            c, g = self.eval_term_obs_cost_diff(obs)
            return c, g, jax.hessian(self.eval_term_obs_cost)(obs)
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Quadratic metadata (cost.py:43-68)
    # ------------------------------------------------------------------
    def get_cost_matrices(self):
        if self.is_quad:
            return (
                np.array(self._Q),
                np.array(self._R),
                np.array(self._F),
            )
        raise ValueError("Cost is not quadratic.")

    def get_goal(self):
        if self.has_goal:
            return np.array(self._goal)
        raise ValueError("Cost does not have goal")

    # ------------------------------------------------------------------
    # Capability flags (cost.py:215-248)
    # ------------------------------------------------------------------
    @property
    def is_quad(self):
        return self._is_quad

    @property
    def is_convex(self):
        return self._is_convex

    @property
    def is_diff(self):
        return self._is_diff

    @property
    def is_twice_diff(self):
        return self._is_twice_diff

    @property
    def has_goal(self):
        return self._has_goal

    # ------------------------------------------------------------------
    # Cost algebra (cost.py:250-255)
    # ------------------------------------------------------------------
    def __add__(self, other):
        from .sum_cost import SumCost

        if isinstance(other, SumCost):
            return other.__radd__(self)
        return SumCost(self.system, [self, other])

    # ------------------------------------------------------------------
    # Functional core: the controllers (iLQR/MPPI/DT) close
    # over these pure functions inside their jitted solvers.
    # ------------------------------------------------------------------
    def stage_fns(self):
        """Return (obs_cost_fn, ctrl_cost_fn, term_cost_fn) pure fns."""
        return self.eval_obs_cost, self.eval_ctrl_cost, self.eval_term_obs_cost
