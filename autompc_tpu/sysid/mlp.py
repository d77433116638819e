"""MLP dynamics model.

Re-creates the reference MLP system-ID model (reference:
autompc/sysid/mlp.py:32-321) — a feed-forward net predicting the
z-scored state delta, trained with Adam on a smooth-L1 loss — without
torch: the net is a parameter pytree with a pure apply function, and the
**entire training run (all epochs × batches) is one jitted
``lax.scan``** — zero host↔device round-trips per step (the reference
re-enters Python and syncs CUDA every minibatch, mlp.py:205-214).
Jacobians come from ``jax.jacfwd`` through the net (replacing the
repeated-input backward trick, mlp.py:232-305).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    InCondition,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from ..core.trajectory import batch as traj_batch
from .model import Model, ModelFactory

_NONLIN = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "selu": jax.nn.selu,
}


def net_init(key, sizes):
    """LeCun-style init matching torch.nn.Linear defaults
    (U[-1/sqrt(fan_in), 1/sqrt(fan_in)])."""
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        key, k1, k2 = jax.random.split(key, 3)
        bound = 1.0 / np.sqrt(n_in)
        W = jax.random.uniform(k1, (n_in, n_out), minval=-bound, maxval=bound)
        b = jax.random.uniform(k2, (n_out,), minval=-bound, maxval=bound)
        params.append({"W": W, "b": b})
    return params


def net_apply(params, x, nonlin):
    """Hidden layers with nonlinearity, linear output head
    (mlp.py:55-59)."""
    act = _NONLIN[nonlin]
    for layer in params[:-1]:
        x = act(x @ layer["W"] + layer["b"])
    out = params[-1]
    return x @ out["W"] + out["b"]


_NONLIN_DERIV = {
    # d act / d a, elementwise, in terms of the PRE-activation a.
    "relu": lambda a: (a > 0).astype(a.dtype),
    "tanh": lambda a: 1.0 - jnp.tanh(a) ** 2,
    "sigmoid": lambda a: jax.nn.sigmoid(a) * (1.0 - jax.nn.sigmoid(a)),
    # jax.nn.selu constants (Klambauer et al. 2017).
    "selu": lambda a: 1.0507009873554805 * jnp.where(
        a > 0, 1.0, 1.6732632423543772 * jnp.exp(a)
    ),
}


def net_apply_jac(params, x, nonlin):
    """Forward pass AND the closed-form input Jacobian in one sweep.

    The chain rule for the feed-forward stack is
    ``J = W_L' D_{L-1} W_{L-1}' ... D_1 W_1'`` with ``D_i`` the diagonal
    of activation derivatives at layer i — one small matmul per layer
    instead of the ``n_in`` tangent pushforwards ``jax.jacfwd`` runs
    (the reference computes batch Jacobians with a repeated-input
    backward trick for the same reason, autompc/sysid/mlp.py:281-305).
    At halfcheetah scale (24 inputs, 2x64 hidden) this is ~25% of
    jacfwd's flops and keeps every op a dense matmul — the
    relinearization phase of the batched iLQR solve consumes it via
    ``make_batched_ilqr_solver(pred_diff=...)``.

    Returns ``(out (n_out,), J (n_out, n_in))``.
    """
    act = _NONLIN[nonlin]
    dact = _NONLIN_DERIV[nonlin]
    J = None  # (cur_dim, n_in)
    for layer in params[:-1]:
        a = x @ layer["W"] + layer["b"]
        d = dact(a)
        # da/dx = W' (rows index outputs); fold the diagonal in.
        J = (
            d[:, None] * layer["W"].T
            if J is None
            else d[:, None] * (layer["W"].T @ J)
        )
        x = act(a)
    out = params[-1]
    J = out["W"].T if J is None else out["W"].T @ J
    return x @ out["W"] + out["b"], J


class MLPFactory(ModelFactory):
    """Hyperparameters (mlp.py:106-140):

    - *n_hidden_layers* (categorical ["1","2","3","4"], default "2")
    - *hidden_size_i* (int, 16..256, default 128; conditioned on
      n_hidden_layers >= i)
    - *nonlintype* (categorical [relu, tanh, sigmoid, selu])
    - *lr* (float, 1e-5..1, log, default 1e-3)
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = MLP
        self.name = "MLP"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        nonlintype = CategoricalHyperparameter(
            "nonlintype", choices=["relu", "tanh", "sigmoid", "selu"],
            default_value="relu",
        )
        n_hidden_layers = CategoricalHyperparameter(
            "n_hidden_layers", choices=["1", "2", "3", "4"], default_value="2"
        )
        hs = [
            UniformIntegerHyperparameter(
                f"hidden_size_{i}", lower=16, upper=256, default_value=128
            )
            for i in (1, 2, 3, 4)
        ]
        lr = UniformFloatHyperparameter(
            "lr", lower=1e-5, upper=1.0, default_value=1e-3, log=True
        )
        cs.add_hyperparameters([nonlintype, n_hidden_layers, *hs, lr])
        cs.add_conditions(
            [
                InCondition("hidden_size_2", "n_hidden_layers", ["2", "3", "4"]),
                InCondition("hidden_size_3", "n_hidden_layers", ["3", "4"]),
                InCondition("hidden_size_4", "n_hidden_layers", ["4"]),
            ]
        )
        return cs


class MLP(Model):
    def __init__(
        self,
        system,
        n_hidden_layers=3,
        hidden_size=128,
        nonlintype="relu",
        n_train_iters=50,
        n_batch=64,
        lr=1e-3,
        hidden_size_1=None,
        hidden_size_2=None,
        hidden_size_3=None,
        hidden_size_4=None,
        seed=100,
        use_cuda=None,  # API parity; the platform picks the device
    ):
        super().__init__(system)
        nx, nu = system.obs_dim, system.ctrl_dim
        n_hidden_layers = int(n_hidden_layers)
        hidden_sizes = [int(hidden_size)] * n_hidden_layers
        for i, size in enumerate(
            [hidden_size_1, hidden_size_2, hidden_size_3, hidden_size_4]
        ):
            if size is not None and i < n_hidden_layers:
                hidden_sizes[i] = int(size)
        self.hidden_sizes = hidden_sizes
        self.nonlintype = nonlintype
        self.n_train_iters = int(n_train_iters)
        self.n_batch = int(n_batch)
        self.lr = float(lr)
        self.seed = int(seed)
        self._sizes = [nx + nu] + hidden_sizes + [nx]

        key = jax.random.PRNGKey(self.seed)
        self.net_params = net_init(key, self._sizes)
        self.xu_means = jnp.zeros(nx + nu)
        self.xu_std = jnp.ones(nx + nu)
        self.dy_means = jnp.zeros(nx)
        self.dy_std = jnp.ones(nx)

    # -- state handling (mlp.py:167-176) --------------------------------
    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    @property
    def state_dim(self):
        return self.system.obs_dim

    # -- training -------------------------------------------------------
    def train(self, trajs, silent=False, seed=None):
        tb = traj_batch(trajs)
        mask = np.asarray(tb.step_mask())
        obs = np.asarray(tb.obs)
        ctrls = np.asarray(tb.ctrls)
        # Valid (x_t, u_t) -> dy_t pairs flattened on host once;
        # device-resident thereafter.
        idx_b, idx_t = np.nonzero(mask)
        X = obs[idx_b, idx_t]
        U = ctrls[idx_b, idx_t]
        dY = obs[idx_b, idx_t + 1] - obs[idx_b, idx_t]
        XU = np.concatenate([X, U], axis=1)

        self.xu_means = jnp.asarray(XU.mean(axis=0))
        xu_std = XU.std(axis=0)
        self.xu_std = jnp.asarray(np.where(xu_std > 1e-12, xu_std, 1.0))
        self.dy_means = jnp.asarray(dY.mean(axis=0))
        dy_std = dY.std(axis=0)
        self.dy_std = jnp.asarray(np.where(dy_std > 1e-12, dy_std, 1.0))

        XUt = (jnp.asarray(XU) - self.xu_means) / self.xu_std
        dYt = (jnp.asarray(dY) - self.dy_means) / self.dy_std

        seed = self.seed if seed is None else int(seed)
        key = jax.random.PRNGKey(seed)
        key, k_init = jax.random.split(key)
        params = net_init(k_init, self._sizes)

        n = XUt.shape[0]
        nb = max(n // self.n_batch, 1)
        n_used = nb * self.n_batch
        nonlin = self.nonlintype

        opt = optax.adam(self.lr)
        opt_state = opt.init(params)

        def loss_fn(p, xb, yb):
            pred = net_apply(p, xb, nonlin)
            return jnp.mean(optax.huber_loss(pred, yb, delta=1.0))

        @jax.jit
        def train_all(params, opt_state, key):
            def epoch(carry, _):
                params, opt_state, key = carry
                key, kp = jax.random.split(key)
                perm = jax.random.permutation(kp, n)[:n_used]
                xb = XUt[perm].reshape(nb, self.n_batch, -1)
                yb = dYt[perm].reshape(nb, self.n_batch, -1)

                def step(c, batch):
                    params, opt_state = c
                    x, y = batch
                    loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
                    updates, opt_state = opt.update(grads, opt_state, params)
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                (params, opt_state), losses = jax.lax.scan(
                    step, (params, opt_state), (xb, yb)
                )
                return (params, opt_state, key), jnp.mean(losses)

            (params, opt_state, _), losses = jax.lax.scan(
                epoch, (params, opt_state, key), None, length=self.n_train_iters
            )
            return params, losses

        self.net_params, self._losses = train_all(params, opt_state, key)

    # -- prediction ------------------------------------------------------
    @property
    def params(self):
        return {
            "net": self.net_params,
            "xu_means": self.xu_means,
            "xu_std": self.xu_std,
            "dy_means": self.dy_means,
            "dy_std": self.dy_std,
        }

    def pred_core(self, params, state, ctrl):
        xu = jnp.concatenate([state, ctrl])
        xut = (xu - params["xu_means"]) / params["xu_std"]
        dyt = net_apply(params["net"], xut, self.nonlintype)
        dy = dyt * params["dy_std"] + params["dy_means"]
        return state + dy

    def pred_diff_core(self, params, state, ctrl):
        """(pred, Jx, Ju) with the closed-form net Jacobian
        (net_apply_jac) scaled through the z-scoring: the full model
        Jacobian is ``I (state part) + diag(dy_std) J_net diag(1/xu_std)``.
        Feed to ``make_batched_ilqr_solver(pred_diff=...)`` to replace
        the jacfwd relinearization."""
        n = state.shape[0]
        xu = jnp.concatenate([state, ctrl])
        xut = (xu - params["xu_means"]) / params["xu_std"]
        dyt, Jt = net_apply_jac(params["net"], xut, self.nonlintype)
        dy = dyt * params["dy_std"] + params["dy_means"]
        J = (params["dy_std"][:, None] * Jt) / params["xu_std"][None, :]
        Jx = jnp.eye(n, dtype=J.dtype) + J[:, :n]
        return state + dy, Jx, J[:, n:]

    def get_parameters(self):
        return {
            "net_params": jax.tree_util.tree_map(np.array, self.net_params),
            "xu_means": np.array(self.xu_means),
            "xu_std": np.array(self.xu_std),
            "dy_means": np.array(self.dy_means),
            "dy_std": np.array(self.dy_std),
        }

    def set_parameters(self, params):
        self.net_params = jax.tree_util.tree_map(
            jnp.asarray, params["net_params"]
        )
        self.xu_means = jnp.asarray(params["xu_means"])
        self.xu_std = jnp.asarray(params["xu_std"])
        self.dy_means = jnp.asarray(params["dy_means"])
        self.dy_std = jnp.asarray(params["dy_std"])
