"""Koopman lifted-linear model.

Re-creates the reference Koopman model (reference:
autompc/sysid/koopman.py:14-189): lift observations through a basis
(identity + optional polynomial powers + optional trig), then fit
``Psi(x)' = A Psi(x) + B u`` by pseudo-inverse least squares, FISTA
Lasso, or the stable-Koopman projected-gradient solve — all as jitted
device programs (replacing scipy pinv2 / sklearn Lasso / the scipy-based
FGM, koopman.py:145-161).

Note the reference's basis quirks are fixed deliberately: its trig branch
iterates ``range(1, 1+poly_degree)`` (koopman.py:117) and the late-bound
loop variable makes every lambda use the final frequency — here trig
frequencies honestly span ``1..trig_freq``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    InCondition,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import fista_lasso, pinv
from .model import Model, ModelFactory
from .stable_koopman import stabilize_discrete


class KoopmanFactory(ModelFactory):
    r"""Identifies :math:`\Psi(x)' = A\Psi(x) + Bu` over state-only basis
    functions (control-affine lifting, amenable to LQR).

    Hyperparameters (koopman.py:47-81):

    - *method* (categorical ["lstsq", "lasso", "stable"])
    - *lasso_alpha* (float, 1e-10..1e2, log; conditioned on method=lasso)
    - *poly_basis* ("true"/"false"), *poly_degree* (2..8, cond)
    - *trig_basis* ("true"/"false"), *trig_freq* (1..8, cond)
    - *product_terms* (categorical ["false"]: declared but disabled in
      the reference's space — kept for parity)
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = Koopman
        self.name = "Koopman"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        method = CategoricalHyperparameter(
            "method", choices=["lstsq", "lasso", "stable"]
        )
        lasso_alpha = UniformFloatHyperparameter(
            "lasso_alpha", lower=1e-10, upper=1e2, default_value=1.0, log=True
        )
        poly_basis = CategoricalHyperparameter(
            "poly_basis", choices=["true", "false"], default_value="false"
        )
        poly_degree = UniformIntegerHyperparameter(
            "poly_degree", lower=2, upper=8, default_value=3
        )
        trig_basis = CategoricalHyperparameter(
            "trig_basis", choices=["true", "false"], default_value="false"
        )
        trig_freq = UniformIntegerHyperparameter(
            "trig_freq", lower=1, upper=8, default_value=1
        )
        product_terms = CategoricalHyperparameter(
            "product_terms", choices=["false"], default_value="false"
        )
        cs.add_hyperparameters(
            [method, poly_basis, poly_degree, trig_basis, trig_freq,
             product_terms, lasso_alpha]
        )
        cs.add_conditions(
            [
                InCondition("poly_degree", "poly_basis", ["true"]),
                InCondition("trig_freq", "trig_basis", ["true"]),
                InCondition("lasso_alpha", "method", ["lasso"]),
            ]
        )
        return cs


def _as_bool(v):
    return v == "true" if isinstance(v, str) else bool(v)


class Koopman(Model):
    def __init__(
        self,
        system,
        method,
        lasso_alpha=None,
        poly_basis=False,
        poly_degree=1,
        trig_basis=False,
        trig_freq=1,
        product_terms=False,
        use_cuda=None,  # API parity; the platform picks the device
    ):
        super().__init__(system)
        self.method = method
        if method == "lasso" and lasso_alpha is None:
            # A factory method-override can pair method="lasso" with a
            # configuration whose conditional lasso_alpha is inactive;
            # fall back to the space default (1.0) like the tuner's
            # bucket extraction does (tuning/model_tuner.py).
            lasso_alpha = 1.0
        self.lasso_alpha = lasso_alpha
        self.poly_basis = _as_bool(poly_basis)
        self.poly_degree = int(poly_degree)
        self.trig_basis = _as_bool(trig_basis)
        self.trig_freq = int(trig_freq)
        self.product_terms = _as_bool(product_terms)

        # Basis layout: per-function blocks over all obs dims
        # (koopman.py:108-115 layout: [b(x) for b in funcs for x in state]).
        fns = [lambda x: x]
        if self.poly_basis:
            for i in range(2, 1 + self.poly_degree):
                fns.append(lambda x, i=i: x**i)
        if self.trig_basis:
            for i in range(1, 1 + self.trig_freq):
                fns.append(lambda x, i=i: jnp.sin(i * x))
                fns.append(lambda x, i=i: jnp.cos(i * x))
        self._basis_fns = fns
        self.A = None
        self.B = None

    def _apply_basis(self, obs):
        """(obs_dim,) -> (state_dim,) lifted state."""
        parts = [fn(obs) for fn in self._basis_fns]
        lifted = jnp.concatenate(parts)
        if self.product_terms:
            outer = lifted[:, None] * lifted[None, :]
            iu = jnp.triu_indices(lifted.shape[0], k=1)
            lifted = jnp.concatenate([lifted, outer[iu]])
        return lifted

    @property
    def state_dim(self):
        base = len(self._basis_fns) * self.system.obs_dim
        if self.product_terms:
            base += base * (base - 1) // 2
        return base

    # -- state handling (koopman.py:120-131) ----------------------------
    def traj_to_state(self, traj):
        return self._apply_basis(jnp.asarray(traj[-1].obs))

    def traj_to_states(self, traj):
        return jax.vmap(self._apply_basis)(jnp.asarray(traj.obs))

    def update_state_core(self, params, state, new_ctrl, new_obs):
        return self._apply_basis(new_obs)

    # -- training (koopman.py:136-164) ----------------------------------
    def train(self, trajs, silent=False):
        tb = traj_batch(trajs)
        lifted = jax.vmap(jax.vmap(self._apply_basis))(tb.obs)  # (B,T,N)
        mask = tb.step_mask()  # valid (t -> t+1) transitions

        m = np.asarray(mask)
        idx_b, idx_t = np.nonzero(m)
        X = np.asarray(lifted)[idx_b, idx_t].T          # (N, S)
        Y = np.asarray(lifted)[idx_b, idx_t + 1].T      # (N, S)
        U = np.asarray(tb.ctrls)[idx_b, idx_t].T        # (m, S)

        X, Y, U = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(U)
        n = X.shape[0]
        XU = jnp.concatenate([X, U], axis=0)

        if self.method == "lstsq":
            AB = Y @ pinv(XU)
            A, B = AB[:, :n], AB[:, n:]
        elif self.method == "lasso":
            AB = fista_lasso(XU.T, Y.T, self.lasso_alpha).T
            A, B = AB[:, :n], AB[:, n:]
        elif self.method == "stable":
            A, _, _, _, B, _ = stabilize_discrete(X, U, Y)
            A = jnp.real(A)
            B = jnp.real(B)
        else:
            raise ValueError(f"Unknown method {self.method}")

        self.A, self.B = A, B

    # -- prediction ------------------------------------------------------
    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def pred_core(self, params, state, ctrl):
        return params["A"] @ state + params["B"] @ ctrl

    def pred_diff(self, state, ctrl):
        return self.pred(state, ctrl), self.A, self.B

    def pred_diff_batch(self, states, ctrls):
        preds = self.pred_batch(states, ctrls)
        N = preds.shape[0]
        return (
            preds,
            jnp.broadcast_to(self.A, (N,) + self.A.shape),
            jnp.broadcast_to(self.B, (N,) + self.B.shape),
        )

    def to_linear(self):
        return self.A, self.B

    def get_parameters(self):
        return {"A": np.array(self.A), "B": np.array(self.B)}

    def set_parameters(self, params):
        self.A = jnp.asarray(params["A"])
        self.B = jnp.asarray(params["B"])
