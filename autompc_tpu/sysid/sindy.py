"""SINDy: sparse identification of nonlinear dynamics.

Re-creates the reference SINDy model (reference: autompc/sysid/sindy.py:
24-253) without pysindy/sklearn: the feature library is a vectorized jax
map (sysid/basis.py), STLSQ is a fixed-iteration masked-lstsq loop and
Lasso is FISTA (ops/lstsq.py), both fully on device. Jacobians come from
``jax.jacfwd`` through the feature map instead of the reference's
per-basis hand-written gradients (sindy.py:189-244).

Supports discrete-time (fit x_{t+1}) and continuous-time (fit finite-
difference x_dot, integrate with Euler) modes, matching sindy.py:152-187.
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
from ..ops.lstsq import fista_lasso, stlsq
from .basis import FeatureLibrary, finite_difference
from .model import Model, ModelFactory


class SINDyFactory(ModelFactory):
    r"""SINDy fits :math:`\dot{x} = K\,\Theta(x, u)` (or the discrete
    analog) by sequentially-thresholded least squares over a basis
    library.

    Hyperparameters (sindy.py:59-94):

    - *time_mode* (categorical ["discrete", "continuous"])
    - *method* (categorical ["lstsq", "lasso"])
    - *threshold* (float, 1e-5..1e1, log, default 1e-2): STLSQ cut
    - *lasso_alpha* (float, 1e-5..1e2, log; conditioned on method=lasso)
    - *poly_basis* ("true"/"false"), *poly_degree* (2..8, cond),
      *poly_cross_terms* ("true"/"false")
    - *trig_basis* ("true"/"false"), *trig_freq* (1..8, cond),
      *trig_interaction* (cond on trig_basis)
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = SINDy
        self.name = "SINDy"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        time_mode = CategoricalHyperparameter(
            "time_mode", choices=["discrete", "continuous"]
        )
        method = CategoricalHyperparameter("method", choices=["lstsq", "lasso"])
        threshold = UniformFloatHyperparameter(
            "threshold", lower=1e-5, upper=1e1, default_value=1e-2, log=True
        )
        lasso_alpha = UniformFloatHyperparameter(
            "lasso_alpha", lower=1e-5, upper=1e2, default_value=1.0, log=True
        )
        poly_basis = CategoricalHyperparameter(
            "poly_basis", choices=["true", "false"], default_value="false"
        )
        poly_degree = UniformIntegerHyperparameter(
            "poly_degree", lower=2, upper=8, default_value=3
        )
        poly_cross_terms = CategoricalHyperparameter(
            "poly_cross_terms", choices=["true", "false"], default_value="false"
        )
        trig_basis = CategoricalHyperparameter(
            "trig_basis", choices=["true", "false"], default_value="false"
        )
        trig_freq = UniformIntegerHyperparameter(
            "trig_freq", lower=1, upper=8, default_value=1
        )
        trig_interaction = CategoricalHyperparameter(
            "trig_interaction", choices=["true", "false"], default_value="false"
        )
        cs.add_hyperparameters(
            [
                method, lasso_alpha, threshold,
                poly_basis, poly_degree, trig_basis, trig_freq,
                trig_interaction, poly_cross_terms, time_mode,
            ]
        )
        cs.add_conditions(
            [
                InCondition("lasso_alpha", "method", ["lasso"]),
                InCondition("poly_degree", "poly_basis", ["true"]),
                InCondition("trig_freq", "trig_basis", ["true"]),
                InCondition("trig_interaction", "trig_basis", ["true"]),
            ]
        )
        return cs


def _as_bool(v):
    return v == "true" if isinstance(v, str) else bool(v)


class SINDy(Model):
    def __init__(
        self,
        system,
        method,
        lasso_alpha=None,
        threshold=1e-2,
        poly_basis=False,
        poly_degree=1,
        poly_cross_terms=False,
        trig_basis=False,
        trig_freq=1,
        trig_interaction=False,
        time_mode="discrete",
    ):
        super().__init__(system)
        self.method = method
        if method == "lasso" and lasso_alpha is None:
            # Conditional hyperparameter inactive under a factory
            # method-override: use the space default (sindy factory
            # lasso_alpha default 1.0), matching the tuner's bucket
            # extraction fallback.
            lasso_alpha = 1.0
        self.lasso_alpha = lasso_alpha
        self.threshold = threshold
        self.time_mode = time_mode
        self.poly_basis = _as_bool(poly_basis)
        self.poly_degree = int(poly_degree)
        self.poly_cross_terms = _as_bool(poly_cross_terms)
        self.trig_basis = _as_bool(trig_basis)
        self.trig_freq = int(trig_freq)
        self.trig_interaction = _as_bool(trig_interaction)

        n_inputs = system.obs_dim + system.ctrl_dim
        self.library = FeatureLibrary.from_config(
            n_inputs,
            poly_basis=self.poly_basis,
            poly_degree=self.poly_degree,
            poly_cross_terms=self.poly_cross_terms,
            trig_basis=self.trig_basis,
            trig_freq=self.trig_freq,
            trig_interaction=self.trig_interaction,
        )
        self.coeffs = None  # (obs_dim, n_features)

    # -- state handling (sindy.py:125-135) -----------------------------
    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    @property
    def state_dim(self):
        return self.system.obs_dim

    # -- training ------------------------------------------------------
    def train(self, trajs, xdot=None, silent=False):
        tb = traj_batch(trajs)
        n = self.system.obs_dim
        dt = self.system.dt

        # Block-vectorized: one traced call over the whole (B, T, d) batch.
        feats = self.library(
            jnp.concatenate([tb.obs, tb.ctrls], axis=-1)
        )  # (B, T, F)

        if self.time_mode == "continuous":
            if xdot is None:
                targets = jax.vmap(lambda o: finite_difference(o, dt))(tb.obs)
            else:
                targets = jnp.asarray(xdot)
            mask = tb.mask()
        else:
            targets = jnp.roll(tb.obs, -1, axis=1)
            mask = tb.step_mask()

        A = feats.reshape(-1, self.library.n_features)
        y = targets.reshape(-1, n)
        rmask = mask.reshape(-1)

        if self.method == "lasso":
            coefs = fista_lasso(A, y, self.lasso_alpha, mask=rmask)
        else:
            # Normal-equations STLSQ: one Gram staging pass, then (F, F)
            # masked solves — same iteration as ops/lstsq.py:stlsq with
            # ~N/F times less solve work, and the SAME trainer the joint
            # tuning fan-out vmaps per candidate lane
            # (parallel/fanout.py:JointSINDyQuadCostFanout), keeping the
            # fan-out/sequential parity exact.
            from ..ops.lstsq import gram_stage, stlsq, stlsq_gram

            G, bvec = gram_stage(A, y, mask=rmask)
            coefs = stlsq_gram(G, bvec, self.threshold)
            # The Gram pair squares the conditioning; a masked Gram that
            # loses positive-definiteness (likelier in f32) makes the
            # Cholesky emit NaN, which would silently store an all-zero
            # model. The tuner's fan-out scores such lanes inf, but this
            # standalone trainer falls back to the SVD-based STLSQ (a
            # min-norm solution) instead.
            if not bool(jnp.all(jnp.isfinite(coefs))):
                if not silent:
                    print(
                        "SINDy: Gram-staged STLSQ produced non-finite "
                        "coefficients (ill-conditioned normal equations); "
                        "falling back to the SVD least-squares path"
                    )
                coefs = stlsq(A, y, self.threshold, mask=rmask)
        self.coeffs = coefs.T  # (n, F)

    # -- prediction ----------------------------------------------------
    @property
    def params(self):
        return {"coeffs": self.coeffs}

    def pred_core(self, params, state, ctrl):
        theta = self.library(jnp.concatenate([state, ctrl]))
        out = params["coeffs"] @ theta
        if self.time_mode == "continuous":
            return state + self.system.dt * out
        return out

    def get_parameters(self):
        return {"coeffs": np.array(self.coeffs)}

    def set_parameters(self, params):
        self.coeffs = jnp.asarray(params["coeffs"])

    def get_feature_names(self):
        return list(self.library.names)
