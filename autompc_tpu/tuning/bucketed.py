"""Bucketed (shape-padded) batch training for shape-changing model
hyperparameters.

The reference tuner retrains one model per SMAC iteration
(reference: autompc/tuning/model_tuner.py:104-115 via
holdout_evaluator.py:112-121); hyperparameters like the ARX history
window change array shapes, which on an accelerator would mean one compiled
training program per candidate. This module removes that recompile
storm for ARX: every history candidate is padded to the maximum window
``kmax``, the padding is a per-candidate COLUMN MASK on the shared
feature matrix, and all candidates train through one vmapped masked
least-squares solve and score through one vmapped k-step-RMSE metric —
a single compiled program for the whole 1..kmax bucket, reused across
every ask() batch.

Exactness: zeroed feature columns contribute nothing to the residual
and the SVD minimum-norm solution zeroes their coefficients, so the
padded candidate's predictions equal the unpadded ARX(history=k)
model's (test-pinned).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import masked_lstsq


def _arx_feature_col_mask(n, m, kmax, k):
    """0/1 mask over the padded ARX feature vector
    ``[obs, (obs, ctrl) x (kmax-1), 1, ctrl]`` keeping exactly the
    columns an ARX(history=k) model uses (sysid/arx.py state layout)."""
    f = 1 + kmax * (n + m)
    mask = np.zeros(f)
    mask[:n] = 1.0
    blk = n + m
    for i in range(1, k):
        mask[n + (i - 1) * blk : n + i * blk] = 1.0
    mask[-(1 + m):] = 1.0
    return mask


def make_arx_bucket_program(system, kmax: int, horizon: int = 1):
    """Build ``evaluate(train_tb_arrays, holdout_tb_arrays, col_masks)
    -> rmses`` — one jitted program that trains every column-masked ARX
    candidate and scores its k-step holdout RMSE.

    All candidates share the padded state layout of ARX(history=kmax):
    ``ds = n + (kmax-1)(n+m) + 1``; per-candidate companion matrices
    differ only in the coefficient rows.
    """
    from ..sysid.arx import ARX

    n, m = system.obs_dim, system.ctrl_dim
    arx = ARX(system, kmax)
    ds = arx.state_dim
    f = arx._fvec_size()
    blk = n + m

    # Fixed companion structure (sysid/arx.py:_assemble_companion), with
    # the coefficient rows left zero; filled per candidate inside jit.
    A_base = np.zeros((ds, ds))
    B_base = np.zeros((ds, m))
    A_base[-1, -1] = 1.0
    if kmax > 1:
        A_base[n : 2 * n, 0:n] = np.eye(n)
    for i in range(kmax - 2):
        A_base[
            (i + 1) * blk + n : (i + 2) * blk + n,
            i * blk + n : (i + 1) * blk + n,
        ] = np.eye(blk)
    if 2 * n + m <= ds:
        B_base[2 * n : 2 * n + m, :] = np.eye(m)
    A_base = jnp.asarray(A_base)
    B_base = jnp.asarray(B_base)

    def evaluate(train_obs, train_ctrls, train_mask,
                 hold_obs, hold_ctrls, hold_lengths, col_masks):
        """train_obs (Bt, T, n), train_ctrls (Bt, T, m), train_mask
        (Bt, T) valid-transition mask; hold_* the holdout batch;
        col_masks (C, f). Returns (C,) RMSEs."""
        feats = jax.vmap(arx._all_features)(train_obs, train_ctrls)
        targets = jnp.roll(train_obs, -1, axis=1)
        A_mat = feats.reshape(-1, f)
        y = targets.reshape(-1, n)
        rmask = train_mask.reshape(-1)

        def fit_one(cmask):
            coeffs = masked_lstsq(A_mat * cmask[None, :], y, rmask).T
            A = A_base.at[0:n, :].set(coeffs[:, :-m])
            B = B_base.at[0:n, :].set(coeffs[:, -m:])
            return A, B

        As, Bs = jax.vmap(fit_one)(col_masks)          # (C, ds, ds/m)

        T = hold_obs.shape[1]
        hold_states = jax.vmap(
            lambda o, c: arx._all_features(o, c)[:, : f - m]
        )(hold_obs, hold_ctrls)[:, : T - horizon]       # (Bh, T-h, ds)

        def rmse_one(A, B):
            def per_traj(states, obs, ctrls, length):
                def step(carry, k):
                    state, _ = carry
                    u = jax.lax.dynamic_slice_in_dim(
                        ctrls, k, T - horizon, axis=0
                    )
                    new = jnp.einsum("ij,tj->ti", A, state) + jnp.einsum(
                        "ij,tj->ti", B, u
                    )
                    return (new, state), None

                (final, _), _ = jax.lax.scan(
                    step, (states, states), jnp.arange(horizon)
                )
                errs = (final[:, :n] - obs[horizon:]) ** 2
                valid = (jnp.arange(T - horizon) + horizon) < length
                return jnp.sum(errs * valid[:, None]), jnp.sum(valid) * n

            sums, counts = jax.vmap(per_traj)(
                hold_states, hold_obs, hold_ctrls, hold_lengths
            )
            return jnp.sqrt(jnp.sum(sums) / jnp.sum(counts) * n)

        return jax.vmap(rmse_one)(As, Bs), As, Bs

    return jax.jit(evaluate)


class SINDyBucketEvaluator:
    """SINDy bucket: candidates sharing the basis-library configuration
    (method, time_mode, poly/trig settings) differ only in the traced
    regularization scalar — the STLSQ threshold or the lasso alpha — so
    the whole batch trains through one vmapped solve over the shared
    feature matrix and scores through one vmapped k-step RMSE."""

    def __init__(self, system, training_set, holdout, bucket_cfg: dict,
                 horizon: int = 1):
        from ..ops.lstsq import fista_lasso, stlsq
        from ..sysid.sindy import SINDy

        self.system = system
        self.horizon = int(horizon)
        self.method = bucket_cfg.get("method", "lstsq")
        skeleton = SINDy(system, **bucket_cfg)
        library = skeleton.library
        time_mode = skeleton.time_mode
        n = system.obs_dim
        dt = system.dt
        horizon = self.horizon

        tb = traj_batch(training_set)
        feats = library(jnp.concatenate([tb.obs, tb.ctrls], axis=-1))
        if time_mode == "continuous":
            from ..sysid.basis import finite_difference

            targets = jax.vmap(lambda o: finite_difference(o, dt))(tb.obs)
            mask = tb.mask()
        else:
            targets = jnp.roll(tb.obs, -1, axis=1)
            mask = tb.step_mask()
        A = feats.reshape(-1, library.n_features)
        y = targets.reshape(-1, n)
        rmask = mask.reshape(-1)
        # Shared-data Gram staging: every candidate trains against the
        # same matrix, so each lane's STLSQ is (F, F) solves (see
        # JointSINDyQuadCostFanout / ops/lstsq.py:stlsq_gram).
        from ..ops.lstsq import gram_stage, stlsq_gram

        if self.method != "lasso":
            G_mat, b_mat = gram_stage(A, y, mask=rmask)

        tb_h = traj_batch(holdout)
        hobs, hctrls, hlens = tb_h.obs, tb_h.ctrls, tb_h.lengths
        T = hobs.shape[1]
        method = self.method

        def train_eval_one(reg):
            if method == "lasso":
                coefs = fista_lasso(A, y, reg, mask=rmask)
            else:
                coefs = stlsq_gram(G_mat, b_mat, reg)
            coeffs = coefs.T                     # (n, F)

            def pred(states, u):
                theta = library(jnp.concatenate([states, u], axis=-1))
                out = theta @ coeffs.T
                if time_mode == "continuous":
                    return states + dt * out
                return out

            def per_traj(obs, ctrls, length):
                states0 = obs[: T - horizon]

                def step(carry, k):
                    state, _ = carry
                    u = jax.lax.dynamic_slice_in_dim(
                        ctrls, k, T - horizon, axis=0
                    )
                    return (pred(state, u), state), None

                (final, _), _ = jax.lax.scan(
                    step, (states0, states0), jnp.arange(horizon)
                )
                errs = (final - obs[horizon:]) ** 2
                valid = (jnp.arange(T - horizon) + horizon) < length
                return jnp.sum(errs * valid[:, None]), jnp.sum(valid) * n

            sums, counts = jax.vmap(per_traj)(hobs, hctrls, hlens)
            return jnp.sqrt(jnp.sum(sums) / jnp.sum(counts) * n)

        self._program = jax.jit(jax.vmap(train_eval_one))

    def __call__(self, regs):
        """regs: STLSQ thresholds (method=lstsq) or lasso alphas
        (method=lasso). Returns float RMSEs aligned with regs."""
        out = np.asarray(self._program(jnp.asarray(
            [float(r) for r in regs]
        )))
        return [
            float(v) if np.isfinite(v) else float("inf") for v in out
        ]


class KoopmanLassoBucketEvaluator:
    """Koopman (method=lasso) bucket: candidates sharing a lifting
    configuration differ only in the traced lasso alpha, so the lifted
    data matrices are staged once and the batch trains through one
    vmapped FISTA solve + one vmapped k-step RMSE in the lifted space.
    (method=lstsq is parameter-free per basis and method=stable runs the
    FGM loop — neither has a vmappable axis.)"""

    def __init__(self, system, training_set, holdout, bucket_cfg: dict,
                 horizon: int = 1):
        from ..ops.lstsq import fista_lasso
        from ..sysid.koopman import Koopman

        self.system = system
        self.horizon = int(horizon)
        skeleton = Koopman(system, method="lasso", lasso_alpha=1.0,
                           **bucket_cfg)
        lift = skeleton._apply_basis
        N = skeleton.state_dim
        n = system.obs_dim
        horizon = self.horizon

        tb = traj_batch(training_set)
        lifted = jax.vmap(jax.vmap(lift))(tb.obs)        # (B, T, N)
        mask = tb.step_mask()
        X = lifted.reshape(-1, N)
        Y = jnp.roll(lifted, -1, axis=1).reshape(-1, N)
        U = tb.ctrls.reshape(-1, system.ctrl_dim)
        XU = jnp.concatenate([X, U], axis=1)
        rmask = mask.reshape(-1)

        tb_h = traj_batch(holdout)
        hlift = jax.vmap(jax.vmap(lift))(tb_h.obs)       # (Bh, T, N)
        hobs, hctrls, hlens = tb_h.obs, tb_h.ctrls, tb_h.lengths
        T = hobs.shape[1]

        def train_eval_one(alpha):
            AB = fista_lasso(XU, Y, alpha, mask=rmask).T  # (N, N+m)
            A, Bm = AB[:, :N], AB[:, N:]

            def per_traj(states_l, obs, ctrls, length):
                states0 = states_l[: T - horizon]

                def step(carry, k):
                    state, _ = carry
                    u = jax.lax.dynamic_slice_in_dim(
                        ctrls, k, T - horizon, axis=0
                    )
                    new = state @ A.T + u @ Bm.T
                    return (new, state), None

                (final, _), _ = jax.lax.scan(
                    step, (states0, states0), jnp.arange(horizon)
                )
                errs = (final[:, :n] - obs[horizon:]) ** 2
                valid = (jnp.arange(T - horizon) + horizon) < length
                return jnp.sum(errs * valid[:, None]), jnp.sum(valid) * n

            sums, counts = jax.vmap(per_traj)(hlift, hobs, hctrls, hlens)
            return jnp.sqrt(jnp.sum(sums) / jnp.sum(counts) * n)

        self._program = jax.jit(jax.vmap(train_eval_one))

    def __call__(self, alphas):
        out = np.asarray(self._program(jnp.asarray(
            [float(a) for a in alphas]
        )))
        return [
            float(v) if np.isfinite(v) else float("inf") for v in out
        ]


def _mlp_masks(nxu, nx, widths, max_width):
    """Per-layer weight/bias masks embedding an MLP with hidden widths
    ``widths`` inside the max-width net. Masking is applied INSIDE the
    forward pass, so masked entries never influence the loss — their
    gradients are exactly zero and the active entries train exactly as
    the unpadded net's would (Adam moments included)."""
    L = len(widths)
    wmasks, bmasks = [], []
    col = np.zeros(max_width)
    col[: widths[0]] = 1.0
    wmasks.append(np.broadcast_to(col, (nxu, max_width)).copy())
    bmasks.append(col.copy())
    for i in range(1, L):
        row = np.zeros(max_width)
        row[: widths[i - 1]] = 1.0
        col = np.zeros(max_width)
        col[: widths[i]] = 1.0
        wmasks.append(np.outer(row, col))
        bmasks.append(col.copy())
    row = np.zeros(max_width)
    row[: widths[-1]] = 1.0
    wmasks.append(np.broadcast_to(row[:, None], (max_width, nx)).copy())
    bmasks.append(np.ones(nx))
    return wmasks, bmasks


def _mlp_padded_init(key, nxu, nx, widths, max_width):
    """Exactly the per-config net's initial weights (sysid/mlp.py:
    net_init key schedule for the candidate's true sizes), embedded in
    the padded max-width layout."""
    from ..sysid.mlp import net_init

    sizes = [nxu] + [int(w) for w in widths] + [nx]
    small = net_init(key, sizes)
    L = len(widths)
    shapes = (
        [(nxu, max_width)]
        + [(max_width, max_width)] * (L - 1)
        + [(max_width, nx)]
    )
    padded = []
    for layer, shape in zip(small, shapes):
        W = np.zeros(shape)
        w_small = np.asarray(layer["W"])
        W[: w_small.shape[0], : w_small.shape[1]] = w_small
        b = np.zeros(shape[1])
        b_small = np.asarray(layer["b"])
        b[: b_small.shape[0]] = b_small
        padded.append({"W": jnp.asarray(W), "b": jnp.asarray(b)})
    return padded


class MLPBucketEvaluator:
    """Masked max-width MLP bucket: every (widths, lr) candidate with
    the same (n_hidden_layers, nonlintype) trains through ONE compiled
    vmapped program — the whole Adam run (epochs x minibatches as nested
    scans, sysid/mlp.py:198-223 semantics) plus the k-step holdout RMSE.

    Width padding is exact (see _mlp_masks); training matches the
    per-config MLP.train to floating-point reassociation. The per-
    candidate learning rate is traced (scale_by_adam + explicit -lr
    scaling), so one program covers the whole continuous lr range."""

    def __init__(self, system, training_set, holdout, n_hidden_layers,
                 nonlintype, horizon: int = 1, max_width: int = 256,
                 n_train_iters: int = 50, n_batch: int = 64,
                 seed: int = 100):
        import optax

        from ..sysid.mlp import _NONLIN

        self.system = system
        self.L = int(n_hidden_layers)
        self.nonlintype = str(nonlintype)
        self.max_width = int(max_width)
        self.horizon = int(horizon)
        self.seed = int(seed)
        nx, nu = system.obs_dim, system.ctrl_dim
        nxu = nx + nu
        self._nxu, self._nx = nxu, nx

        # Stage training pairs + z-scoring exactly as MLP.train
        # (sysid/mlp.py:158-179).
        tb = traj_batch(training_set)
        mask = np.asarray(tb.step_mask())
        obs = np.asarray(tb.obs)
        ctrls = np.asarray(tb.ctrls)
        idx_b, idx_t = np.nonzero(mask)
        X = obs[idx_b, idx_t]
        U = ctrls[idx_b, idx_t]
        dY = obs[idx_b, idx_t + 1] - obs[idx_b, idx_t]
        XU = np.concatenate([X, U], axis=1)
        xu_means = XU.mean(axis=0)
        xu_std = np.where(XU.std(axis=0) > 1e-12, XU.std(axis=0), 1.0)
        dy_means = dY.mean(axis=0)
        dy_std = np.where(dY.std(axis=0) > 1e-12, dY.std(axis=0), 1.0)
        self._norm = tuple(
            jnp.asarray(v) for v in (xu_means, xu_std, dy_means, dy_std)
        )
        XUt = (jnp.asarray(XU) - self._norm[0]) / self._norm[1]
        dYt = (jnp.asarray(dY) - self._norm[2]) / self._norm[3]

        tb_h = traj_batch(holdout)
        hold = (tb_h.obs, tb_h.ctrls, tb_h.lengths)

        n = XUt.shape[0]
        n_batch = int(n_batch)
        nb = max(n // n_batch, 1)
        n_used = nb * n_batch
        act = _NONLIN[self.nonlintype]
        n_train_iters = int(n_train_iters)
        horizon = self.horizon

        def apply(net, wmasks, bmasks, x):
            for layer, wm, bm in zip(net[:-1], wmasks[:-1], bmasks[:-1]):
                x = act(x @ (layer["W"] * wm) + layer["b"] * bm)
            out, wm, bm = net[-1], wmasks[-1], bmasks[-1]
            return x @ (out["W"] * wm) + out["b"] * bm

        def train_eval_one(params0, wmasks, bmasks, lr, key):
            gtx = optax.scale_by_adam()
            opt_state = gtx.init(params0)

            def loss_fn(p, xb, yb):
                pred = apply(p, wmasks, bmasks, xb)
                return jnp.mean(optax.huber_loss(pred, yb, delta=1.0))

            def epoch(carry, _):
                params, opt_state, key = carry
                key, kp = jax.random.split(key)
                perm = jax.random.permutation(kp, n)[:n_used]
                xb = XUt[perm].reshape(nb, n_batch, -1)
                yb = dYt[perm].reshape(nb, n_batch, -1)

                def step(c, batch_xy):
                    params, opt_state = c
                    x, y = batch_xy
                    loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
                    updates, opt_state = gtx.update(grads, opt_state)
                    updates = jax.tree_util.tree_map(
                        lambda u: -lr * u, updates
                    )
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                (params, opt_state), losses = jax.lax.scan(
                    step, (params, opt_state), (xb, yb)
                )
                return (params, opt_state, key), jnp.mean(losses)

            (params, _, _), _ = jax.lax.scan(
                epoch, (params0, opt_state, key), None,
                length=n_train_iters,
            )

            # k-step holdout RMSE (model_metrics.py semantics) with the
            # MLP delta prediction (sysid/mlp.py:238-243).
            xu_means, xu_std, dy_means, dy_std = self._norm

            def pred(states, u):
                xu = jnp.concatenate([states, u], axis=-1)
                xut = (xu - xu_means) / xu_std
                dyt = apply(params, wmasks, bmasks, xut)
                return states + (dyt * dy_std + dy_means)

            hobs, hctrls, hlens = hold
            T = hobs.shape[1]

            def per_traj(obs, ctrls, length):
                states0 = obs[: T - horizon]

                def step(carry, k):
                    state, _ = carry
                    u = jax.lax.dynamic_slice_in_dim(
                        ctrls, k, T - horizon, axis=0
                    )
                    return (pred(state, u), state), None

                (final, _), _ = jax.lax.scan(
                    step, (states0, states0), jnp.arange(horizon)
                )
                errs = (final - obs[horizon:]) ** 2
                valid = (jnp.arange(T - horizon) + horizon) < length
                return jnp.sum(errs * valid[:, None]), jnp.sum(valid) * nx

            sums, counts = jax.vmap(per_traj)(hobs, hctrls, hlens)
            return jnp.sqrt(jnp.sum(sums) / jnp.sum(counts) * nx)

        self._program = jax.jit(
            jax.vmap(train_eval_one, in_axes=(0, 0, 0, 0, None))
        )

    def __call__(self, width_lists, lrs):
        """width_lists: list of length-L int lists; lrs: list of floats.
        Returns float RMSEs aligned with the candidates."""
        C = len(width_lists)
        key = jax.random.PRNGKey(self.seed)
        key, k_init = jax.random.split(key)
        params0, wmasks, bmasks = [], [], []
        for widths in width_lists:
            params0.append(_mlp_padded_init(
                k_init, self._nxu, self._nx, widths, self.max_width
            ))
            wm, bm = _mlp_masks(
                self._nxu, self._nx, widths, self.max_width
            )
            wmasks.append([jnp.asarray(m) for m in wm])
            bmasks.append([jnp.asarray(m) for m in bm])

        stack = lambda seqs: jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *seqs
        )
        rmses = self._program(
            stack(params0), stack(wmasks), stack(bmasks),
            jnp.asarray([float(lr) for lr in lrs]), key,
        )
        out = np.asarray(rmses)
        return [
            float(v) if np.isfinite(v) else float("inf") for v in out
        ]


class ARXBucketEvaluator:
    """Caches the jitted bucket program and the staged train/holdout
    arrays for a (training_set, holdout, horizon) triple; maps a list of
    history values to holdout RMSEs in one device call."""

    def __init__(self, system, training_set, holdout, kmax: int = 10,
                 horizon: int = 1):
        self.system = system
        self.kmax = int(kmax)
        self.horizon = int(horizon)
        self._program = make_arx_bucket_program(
            system, self.kmax, horizon=self.horizon
        )
        tb_train = traj_batch(training_set)
        tb_hold = traj_batch(holdout)
        self._train_args = (
            tb_train.obs, tb_train.ctrls, tb_train.step_mask(),
        )
        self._hold_args = (tb_hold.obs, tb_hold.ctrls, tb_hold.lengths)
        n, m = system.obs_dim, system.ctrl_dim
        self._masks = jnp.asarray(np.stack([
            _arx_feature_col_mask(n, m, self.kmax, k)
            for k in range(1, self.kmax + 1)
        ]))

    def __call__(self, ks):
        """ks: iterable of history values (1..kmax). Returns a list of
        float RMSEs aligned with ks."""
        ks = list(ks)
        col_masks = self._masks[jnp.asarray([k - 1 for k in ks])]
        rmses, _, _ = self._program(
            *self._train_args, *self._hold_args, col_masks
        )
        out = np.asarray(rmses)
        return [
            float(v) if np.isfinite(v) else float("inf") for v in out
        ]
