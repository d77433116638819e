"""ARX: linear autoregression with exogenous inputs.

Re-creates the reference ARX model (reference: autompc/sysid/arx.py:14-175)
— history-window feature vectors, least-squares fit, companion-form (A, B)
— with an accelerator-native training path: feature matrices for a whole
TrajectoryBatch are built by vectorized shifts and fit with one masked
least-squares solve on device (the reference assembles features row-by-row
in Python, arx.py:88-101).

State layout (parity with arx.py:47-107):
``[obs_t, (obs_{t-1}, ctrl_{t-1}), ..., (obs_{t-k+1}, ctrl_{t-k+1}), 1]``
so ``state_dim = n + (k-1)(n+m) + 1``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import masked_lstsq
from .model import Model, ModelFactory


class ARXFactory(ModelFactory):
    r"""ARX learns :math:`x_{t+1} = [x_t, \ldots, x_{t-k+1}, u_t, \ldots,
    u_{t-k+1}, 1]\,\theta` by least squares.

    Hyperparameters:

    - *history* (int, 1..10, default 4): history window size.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = ARX
        self.name = "ARX"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("history", lower=1, upper=10, default_value=4)
        )
        return cs


class ARX(Model):
    def __init__(self, system, history):
        super().__init__(system)
        self.k = int(history)
        self.A = None
        self.B = None
        self.coeffs = None

    # -- dimensions ----------------------------------------------------
    def _fvec_size(self) -> int:
        n, m, k = self.system.obs_dim, self.system.ctrl_dim, self.k
        return 1 + k * (n + m)

    @property
    def state_dim(self) -> int:
        return self._fvec_size() - self.system.ctrl_dim

    # -- feature construction (vectorized arx.py:61-75) ----------------
    def _all_features(self, obs, ctrls):
        """(T, n), (T, m) -> (T, fvec_size). Row r is the feature vector
        whose prediction target is obs[r+1]: [obs_r, obs_{r-1}, ctrl_{r-1},
        ..., obs_{r-k+1}, ctrl_{r-k+1}, 1, ctrl_r], clamping history
        before t=0 to the first step (arx.py:52-57)."""
        T = obs.shape[0]

        def shift(x, i):
            # Clamp so trajectories shorter than the history window still
            # produce T rows (everything saturates at the first step).
            pad = min(i, T)
            return jnp.concatenate(
                [jnp.repeat(x[:1], pad, axis=0), x[: max(T - i, 0)]], axis=0
            )

        parts = [obs]
        for i in range(1, self.k):
            parts.append(shift(obs, i))
            parts.append(shift(ctrls, i))
        parts.append(jnp.ones((T, 1), dtype=obs.dtype))
        parts.append(ctrls)
        return jnp.concatenate(parts, axis=1)

    # -- reference-parity state handling -------------------------------
    def traj_to_state(self, traj):
        feats = self._all_features(traj.obs, traj.ctrls)
        return feats[-1, : -self.system.ctrl_dim]

    def traj_to_states(self, traj):
        feats = self._all_features(traj.obs, traj.ctrls)
        return feats[:, : -self.system.ctrl_dim]

    def state_to_obs(self, state):
        return state[: self.system.obs_dim]

    def update_state_core(self, params, state, new_ctrl, new_obs):
        # Advance the companion system, then overwrite the predicted obs
        # with the measured one (arx.py:103-108).
        newstate = params["A"] @ state + params["B"] @ new_ctrl
        return newstate.at[: self.system.obs_dim].set(new_obs)

    # -- training ------------------------------------------------------
    def train(self, trajs, silent=False):
        tb = traj_batch(trajs)
        feats = jax.vmap(self._all_features)(tb.obs, tb.ctrls)  # (B,T,f)
        targets = jnp.roll(tb.obs, -1, axis=1)  # row r -> obs[r+1]
        mask = tb.step_mask()  # valid transitions only

        f = self._fvec_size()
        A_mat = feats.reshape(-1, f)
        y = targets.reshape(-1, self.system.obs_dim)
        coeffs = masked_lstsq(A_mat, y, mask.reshape(-1)).T  # (n, f)
        self.coeffs = coeffs
        self._assemble_companion(np.asarray(coeffs))

    def _assemble_companion(self, coeffs: np.ndarray):
        """Build companion-form (A, B) from regression coefficients
        (arx.py:119-143 semantics)."""
        n, m, k = self.system.obs_dim, self.system.ctrl_dim, self.k
        ds = self.state_dim
        A = np.zeros((ds, ds))
        B = np.zeros((ds, m))
        blk = n + m

        # Constant term carries through.
        A[-1, -1] = 1.0
        # Shift current obs into the first history slot.
        if k > 1:
            A[n : 2 * n, 0:n] = np.eye(n)
        # Shift older history pairs down.
        for i in range(k - 2):
            A[(i + 1) * blk + n : (i + 2) * blk + n, i * blk + n : (i + 1) * blk + n] = (
                np.eye(blk)
            )
        # Predict new observation from [obs, history, 1].
        A[0:n, :] = coeffs[:, :-m]
        # New control: prediction contribution + enters history.
        B[0:n, :] = coeffs[:, -m:]
        if 2 * n + m <= ds:
            B[2 * n : 2 * n + m, :] = np.eye(m)

        self.A = jnp.asarray(A)
        self.B = jnp.asarray(B)

    # -- prediction ----------------------------------------------------
    def pred_core(self, params, state, ctrl):
        return params["A"] @ state + params["B"] @ ctrl

    def pred_diff(self, state, ctrl):
        # Linear model: Jacobians are (A, B) exactly.
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

    # -- parameters ----------------------------------------------------
    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def get_parameters(self):
        return {
            "coeffs": np.array(self.coeffs),
            "A": np.array(self.A),
            "B": np.array(self.B),
        }

    def set_parameters(self, params):
        self.coeffs = jnp.asarray(params["coeffs"])
        self.A = jnp.asarray(params["A"])
        self.B = jnp.asarray(params["B"])
