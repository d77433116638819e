"""MPPI: model-predictive path-integral control.

Re-creates the reference MPPI controller (reference:
autompc/control/mppi.py:43-182) — sample perturbed control sequences,
batch-roll them through the model, exponentially weight by cost, update
the nominal sequence — as one fused XLA program per control step:

* all ``num_path`` rollouts advance together in a single
  ``lax.scan`` over the horizon with the path batch vmapped inside
  (replacing the per-step Python loop + slow per-path cost loop,
  mppi.py:73-78, 133-144)
* randomness is an explicit ``jax.random`` key threaded through the
  controller state (the reference reseeds global numpy, mppi.py:26)
* the dead ``MPPICopy`` + multiprocessing fan-out path
  (mppi.py:184-391) is superseded by ``vmap`` on one chip and
  ``shard_map`` across chips (parallel/).

The accelerator-native default is 4096 sampled rollouts per step (BASELINE.json
north star); the reference's tunable range 100..1000 is kept in the
factory space.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    ConfigurationSpace,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from .controller import Controller, ControllerFactory


class MPPIFactory(ControllerFactory):
    """Hyperparameters (mppi.py:50-63):

    - *horizon* (int, 5..30, default 20)
    - *sigma* (float, 1e-4..2.0, default 1.0): perturbation variance
    - *lmda* (float, 0.1..2.0, default 1.0): temperature
    - *num_path* (int, 100..1000, default 200): sampled rollouts/step
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = MPPI
        self.name = "MPPI"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=5, upper=30, default_value=20)
        )
        cs.add_hyperparameter(
            UniformFloatHyperparameter("sigma", lower=1e-4, upper=2.0, default_value=1.0)
        )
        cs.add_hyperparameter(
            UniformFloatHyperparameter("lmda", lower=0.1, upper=2.0, default_value=1.0)
        )
        cs.add_hyperparameter(
            UniformIntegerHyperparameter(
                "num_path", lower=100, upper=1000, default_value=200
            )
        )
        return cs


class MPPI(Controller):
    def __init__(self, system, task, model, **kwargs):
        """Extra accelerator-native kwargs beyond the reference's
        (mppi.py:50-63): ``mesh`` — a ``jax.sharding.Mesh`` whose FIRST
        axis shards the sampled-rollout batch across devices (the
        ``rollout`` axis of SURVEY §2c; lets num_path scale past one
        device's memory and FLOPs). The path batch, noise draws, and
        per-path costs carry sharding constraints; XLA inserts the
        collectives for the softmax-weight reduction."""
        super().__init__(system, task, model)
        self.kwargs = kwargs
        cost = task.get_cost()
        self.H = int(kwargs.get("horizon", 20))
        self.num_path = int(kwargs.get("num_path", 1000))
        self.niter = int(kwargs.get("niter", 1))
        self.sigma = float(kwargs.get("sigma", 1.0))
        self.lmda = float(kwargs.get("lmda", 1.0))
        self.seed = int(kwargs.get("seed", 0))
        self.mesh = kwargs.get("mesh", None)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            axis = self.mesh.axis_names[0]
            n_shard = self.mesh.devices.shape[0]
            if self.num_path % n_shard != 0:
                raise ValueError(
                    f"num_path {self.num_path} not divisible by mesh "
                    f"axis '{axis}' size {n_shard}"
                )
            self._path_sharding = NamedSharding(
                self.mesh, PartitionSpec(axis)
            )
            self._eps_sharding = NamedSharding(
                self.mesh, PartitionSpec(None, axis)
            )
        self.dim_state = model.state_dim
        self.dim_ctrl = system.ctrl_dim

        bounds = task.get_ctrl_bounds()
        self._umin = jnp.asarray(bounds[:, 0])
        self._umax = jnp.asarray(bounds[:, 1])
        # Controls are optimized in normalized units and scaled by umax
        # (mppi.py:91, 139-144); unbounded dims scale by 1.
        scale = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1.0)
        self._ctrl_scale = jnp.asarray(scale)
        self._cost = cost
        self._model_params = model.params
        self._obs_dim = system.obs_dim

    # -- controller-state handling -------------------------------------
    def traj_to_state(self, traj):
        key = jax.random.PRNGKey(self.seed)
        key, k0 = jax.random.split(key)
        # Initial nominal sequence is a noise draw with std sqrt(sigma)
        # (mppi.py:88-90: MultivariateNormal scale = sqrt(cov)).
        act_sequence = jnp.sqrt(self.sigma) * jax.random.normal(
            k0, (self.H, self.dim_ctrl)
        )
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=jnp.asarray(traj[-1].ctrl),
            act_sequence=act_sequence,
            key=key,
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return True

    # -- rollouts ------------------------------------------------------
    def _do_rollouts(self, params, x0, act_sequence, key, eps=None):
        """(costs[num_path], eps[H, num_path, dc]) for one shifted
        nominal sequence (mppi.py:120-152 semantics).

        ``eps`` injects the perturbation draws directly (shape
        (H, num_path, dc), normalized units) — the deterministic hook
        the executed-reference parity tests use to feed both
        implementations identical noise (tests/test_reference_parity.py).
        """
        cost = self._cost
        scale = self._ctrl_scale
        umin_n = self._umin / scale
        umax_n = self._umax / scale

        if eps is None:
            eps = jnp.sqrt(self.sigma) * jax.random.normal(
                key, (self.H, self.num_path, self.dim_ctrl)
            )
        path0 = jnp.broadcast_to(x0, (self.num_path, self.dim_state))
        if self.mesh is not None:
            eps = jax.lax.with_sharding_constraint(eps, self._eps_sharding)
            path0 = jax.lax.with_sharding_constraint(
                path0, self._path_sharding
            )

        def stage(carry, inp):
            path, costs, act_cost = carry
            eps_i, seq_i = inp
            actions = jnp.clip(eps_i + seq_i, umin_n, umax_n)
            eps_adj = actions - seq_i
            scaled = actions * scale
            step_cost = jax.vmap(
                lambda p, a: cost.eval_obs_cost(p[: self._obs_dim])
                + cost.eval_ctrl_cost(a)
            )(path, scaled)
            costs = costs + step_cost
            act_cost = act_cost + self.lmda / self.sigma * jnp.sum(
                actions * eps_adj, axis=1
            )
            path = jax.vmap(lambda p, a: self.model.pred_core(params, p, a))(
                path, scaled
            )
            return (path, costs, act_cost), eps_adj

        (path, costs, act_cost), eps_out = jax.lax.scan(
            stage,
            (path0, jnp.zeros(self.num_path), jnp.zeros(self.num_path)),
            (eps, act_sequence),
        )
        term = jax.vmap(lambda p: cost.eval_term_obs_cost(p[: self._obs_dim]))(path)
        return costs + term + act_cost, eps_out

    def _update_sequence(self, seq, costs, eps):
        """Exponential-weighting sequence update (mppi.py:110-118):
        softmax weights over path costs, noise-weighted correction."""
        S = jnp.exp(-(costs - jnp.min(costs)) / self.lmda)
        weight = S / jnp.sum(S)
        return seq + jnp.sum(eps * weight[None, :, None], axis=1)

    def step(self, cstate, new_obs):
        params = self._model_params
        x0 = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs
        )
        seq = cstate["act_sequence"]
        key = cstate["key"]
        for _ in range(self.niter):
            # Shift the nominal sequence (mppi.py:122-123).
            seq = jnp.concatenate([seq[1:], seq[-1:]], axis=0)
            key, k_noise = jax.random.split(key)
            costs, eps = self._do_rollouts(params, x0, seq, k_noise)
            seq = self._update_sequence(seq, costs, eps)

        u = seq[0] * self._ctrl_scale
        return u, dict(
            model_state=x0, last_u=u, act_sequence=seq, key=key
        )
