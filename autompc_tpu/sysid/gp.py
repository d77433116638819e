"""Approximate (variational sparse) Gaussian-process dynamics model.

Re-creates the reference's GPyTorch-based SVGP model (reference:
autompc/sysid/largegp.py:43-441): a batch-independent multitask GP — one
independent sparse GP per observation dimension — over the z-scored state
delta, with learned inducing points, RBF(+scale) kernel, constant mean,
and Gaussian likelihood, trained by Adam on the variational ELBO.

Accelerator-native re-design: every task's GP is a *vmapped* parameter
slice, so kernel evaluations, Cholesky factorizations, ELBO, and
predictions for all output dimensions run as one batched program; the
whole training loop (epochs x minibatches) is a jitted ``lax.scan``.
Mean-prediction Jacobians come from ``jax.jacfwd`` through the
predictive mean (replacing largegp.py:161-207's repeated-input backward
trick); posterior sampling uses the predictive Cholesky like
largegp.py:83-121.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..core.trajectory import batch as traj_batch
from .model import Model, ModelFactory

_JITTER = 1e-6


def _rbf(x1, x2, lengthscale, outputscale):
    """Scaled RBF kernel matrix: x1 (N,d), x2 (M,d) -> (N,M)."""
    diff = x1[:, None, :] - x2[None, :, :]
    sq = jnp.sum((diff / lengthscale) ** 2, axis=-1)
    return outputscale * jnp.exp(-0.5 * sq)


def _task_predict(tp, x):
    """Predictive mean/cov of one task's SVGP at inputs x (N,d).

    Whitened variational parametrization — learn (v, L_V) with
    ``q(u) = N(mu0 + Lz v, Lz V Lz')``, ``V = L_V L_V'``:

      A    = Lz^{-1} Kzx                      (whitened cross-cov)
      mean = mu0 + A' v
      cov  = Kxx - A'A + A' V A

    Well-conditioned regardless of cond(Kzz), with KL independent of the
    kernel (the unwhitened form's KL carries trace(Kzz^{-1}) ~ 1e6 at
    init and swamps the data term).
    """
    Z = tp["Z"]
    ls = jnp.exp(tp["log_lengthscale"])
    os_ = jnp.exp(tp["log_outputscale"])
    mean_const = tp["mean_const"]
    v = tp["m"]
    Lv = jnp.tril(tp["Ls"])

    M = Z.shape[0]
    Kzz = _rbf(Z, Z, ls, os_) + _JITTER * jnp.eye(M)
    Kxz = _rbf(x, Z, ls, os_)
    Lz = jnp.linalg.cholesky(Kzz)
    A = jax.scipy.linalg.solve_triangular(Lz, Kxz.T, lower=True)  # (M, N)
    mean = mean_const + A.T @ v
    Kxx = _rbf(x, x, ls, os_)
    VA = Lv.T @ A
    cov = Kxx - A.T @ A + VA.T @ VA
    return mean, cov


def _task_elbo(tp, x, y, n_total):
    """Minibatch ELBO for one task (whitened KL)."""
    M = tp["Z"].shape[0]
    noise = jnp.exp(tp["log_noise"])
    mean, cov = _task_predict(tp, x)
    var_f = jnp.clip(jnp.diag(cov), 1e-10)
    # Expected log likelihood under q(f) for Gaussian likelihood.
    ell = -0.5 * (
        jnp.log(2 * jnp.pi * noise)
        + ((y - mean) ** 2 + var_f) / noise
    )
    B = x.shape[0]
    ell_scaled = n_total / B * jnp.sum(ell)
    # Whitened KL(q||p) = 0.5 (||L_V||_F^2 + ||v||^2 - M - 2 log|det L_V|).
    Lv = jnp.tril(tp["Ls"])
    logdet_q = 2 * jnp.sum(jnp.log(jnp.abs(jnp.diag(Lv)) + 1e-12))
    kl = 0.5 * (
        jnp.sum(Lv**2) + jnp.sum(tp["m"] ** 2) - M - logdet_q
    )
    return ell_scaled - kl


_PAD_DIST = 1e4


def pad_inducing_params(params, M_real, pad_to):
    """Pad a per-task SVGP parameter pytree from ``M_real`` to
    ``pad_to`` inducing points with EXACT no-op dummies.

    Dummy inducing points sit at pairwise-far locations
    (``_PAD_DIST * (i+1)`` per coordinate), so every RBF cross-kernel
    entry involving a dummy underflows to exactly 0.0 in f32/f64; with
    ``v`` rows zero and ``L_V`` dummy block identity, the whitened ELBO
    (_task_elbo), its gradients w.r.t. every REAL parameter, and the
    predictive mean (_task_predict / the cached-weights pred_core) are
    numerically IDENTICAL to the unpadded model — adding exact zeros to
    a sum is exact, and the KL's +M_pad from ||I||_F^2 cancels its -M
    term. Verified against unpadded training in tests/test_gp.py.

    This is what makes a multi-induce_count candidate batch one
    program: every bucket trains/evaluates at shape ``pad_to``
    (the reference trains a fresh SVGP per candidate for any
    induce_count, largegp.py:356-416)."""
    n_task, M0, d = params["Z"].shape
    assert M0 == M_real
    n_pad = pad_to - M_real
    if n_pad == 0:
        return params
    pad_z = _PAD_DIST * (
        1.0 + jnp.arange(n_pad, dtype=params["Z"].dtype)
    )[:, None] * jnp.ones((n_pad, d), params["Z"].dtype)
    Z = jnp.concatenate(
        [params["Z"], jnp.broadcast_to(pad_z, (n_task, n_pad, d))], axis=1
    )
    m = jnp.concatenate(
        [params["m"], jnp.zeros((n_task, n_pad), params["m"].dtype)],
        axis=1,
    )
    Ls = jnp.zeros((n_task, pad_to, pad_to), params["Ls"].dtype)
    Ls = Ls.at[:, :M_real, :M_real].set(params["Ls"])
    Ls = Ls.at[
        :, jnp.arange(M_real, pad_to), jnp.arange(M_real, pad_to)
    ].set(1.0)
    return {**params, "Z": Z, "m": m, "Ls": Ls}


class ApproximateGPModelFactory(ModelFactory):
    """Hyperparameters (largegp.py:333-347):

    - *induce_count* (int, 50..200, default 100): inducing points.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = ApproximateGPModel
        self.name = "ApproximateGP"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter(
                "induce_count", lower=50, upper=200, default_value=100
            )
        )
        return cs


class ApproximateGPModel(Model):
    def __init__(
        self,
        system,
        mean="constant",
        kernel="RBF",
        niter=5,
        lr=0.1,
        batch_size=1024,
        induce_count=500,
        seed=100,
        use_cuda=None,  # API parity; the platform picks the device
    ):
        super().__init__(system)
        if kernel != "RBF":
            raise ValueError("Only the RBF kernel is supported (parity)")
        self.niter = int(niter)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.induce_count = int(induce_count)
        self.seed = int(seed)
        self._params = None
        self.xu_means = None

    # -- state handling (largegp.py:63-70) ------------------------------
    def traj_to_state(self, traj):
        return jnp.asarray(traj[-1].obs)

    @property
    def state_dim(self):
        return self.system.obs_dim

    # -- training (largegp.py:356-416) -----------------------------------
    def train(self, trajs, silent=False):
        tb = traj_batch(trajs)
        mask = np.asarray(tb.step_mask())
        obs = np.asarray(tb.obs)
        ctrls = np.asarray(tb.ctrls)
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

        n_total, d = XUt.shape
        n_task = self.system.obs_dim
        M = min(self.induce_count, n_total)

        # Inducing points initialized from the first M training inputs
        # per task (largegp.py:381).
        Z0 = jnp.broadcast_to(XUt[:M], (n_task, M, d))
        params = {
            "Z": Z0,
            "log_lengthscale": jnp.zeros((n_task, d)),
            "log_outputscale": jnp.zeros((n_task,)),
            "log_noise": jnp.full((n_task,), np.log(0.1)),
            "mean_const": jnp.zeros((n_task,)),
            "m": jnp.zeros((n_task, M)),
            "Ls": jnp.broadcast_to(jnp.eye(M), (n_task, M, M)),
        }

        B = min(self.batch_size, n_total)
        nb = max(n_total // B, 1)
        n_used = nb * B
        opt = optax.adam(self.lr)
        opt_state = opt.init(params)

        def task_slice(p, t):
            return {
                "Z": p["Z"][t],
                "log_lengthscale": p["log_lengthscale"][t],
                "log_outputscale": p["log_outputscale"][t],
                "log_noise": p["log_noise"][t],
                "mean_const": p["mean_const"][t],
                "m": p["m"][t],
                "Ls": p["Ls"][t],
            }

        def loss_fn(p, xb, yb):
            elbos = jnp.stack(
                [
                    _task_elbo(task_slice(p, t), xb, yb[:, t], n_total)
                    for t in range(n_task)
                ]
            )
            return -jnp.sum(elbos)

        key = jax.random.PRNGKey(self.seed)

        @jax.jit
        def train_all(params, opt_state, key):
            def epoch(carry, _):
                params, opt_state, key = carry
                key, kp = jax.random.split(key)
                perm = jax.random.permutation(kp, n_total)[:n_used]
                xb = XUt[perm].reshape(nb, B, d)
                yb = dYt[perm].reshape(nb, B, n_task)

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

            (params, _, _), losses = jax.lax.scan(
                epoch, (params, opt_state, key), None, length=self.niter
            )
            return params, losses

        self._params, self._losses = train_all(params, opt_state, key)

    # -- prediction -------------------------------------------------------
    @property
    def params(self):
        # Cached mean-prediction weights: mean(x) = mean_const +
        # k(x, Z) @ w with w = Lz^{-T} v — the predictive mean of the
        # whitened SVGP (_task_predict) with the input-independent
        # triangular solves hoisted out. pred_core then costs one
        # (M, d) kernel row per task instead of an (M, M) Cholesky per
        # call — the difference between a GP surrogate being usable
        # inside vmapped closed-loop rollouts/iLQR and not.
        gp = self._params
        w = svgp_mean_weights(gp)
        return {
            "gp": self._params,
            "w": w,
            "xu_means": self.xu_means,
            "xu_std": self.xu_std,
            "dy_means": self.dy_means,
            "dy_std": self.dy_std,
        }

    def _predictive(self, params, state, ctrl):
        """Per-task predictive mean and variance (with likelihood noise)
        at one (state, ctrl). Returns (mean_dy_t, var_dy_t) each
        (n_task,) in normalized units."""
        xu = jnp.concatenate([state, ctrl])
        xut = ((xu - params["xu_means"]) / params["xu_std"])[None, :]
        gp = params["gp"]
        n_task = self.system.obs_dim

        def one_task(t):
            tp = jax.tree_util.tree_map(lambda a: a[t], gp)
            mean, cov = _task_predict(tp, xut)
            return mean[0], cov[0, 0] + jnp.exp(tp["log_noise"])

        means, variances = jax.vmap(one_task)(jnp.arange(n_task))
        return means, variances

    def pred_core(self, params, state, ctrl):
        if "w" in params:
            # Cached-weights mean path (see ``params``): one kernel row
            # per task, no per-call factorization. Identical to the
            # _predictive mean by construction (pinned in test_gp.py).
            return gp_pred_core_cached(params, state, ctrl)
        mean_t, _ = self._predictive(params, state, ctrl)
        dy = mean_t * params["dy_std"] + params["dy_means"]
        return state + dy

    def sample_core(self, params, state, ctrl, key):
        """Posterior-predictive sample (largegp.py:104-121: independent
        tasks => diagonal predictive covariance)."""
        mean_t, var_t = self._predictive(params, state, ctrl)
        eps = jax.random.normal(key, mean_t.shape)
        draw = mean_t + jnp.sqrt(jnp.clip(var_t, 1e-12)) * eps
        dy = draw * params["dy_std"] + params["dy_means"]
        return state + dy

    def sample(self, state, ctrl, key=None):
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(1 << 31))
        return self.sample_core(self.params, jnp.asarray(state), jnp.asarray(ctrl), key)

    def sample_parallel(self, states, ctrls, key=None):
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(1 << 31))
        keys = jax.random.split(key, states.shape[0])
        return jax.vmap(partial(self.sample_core, self.params))(
            jnp.asarray(states), jnp.asarray(ctrls), keys
        )

    def get_sampler(self, key=None):
        """Sampler with one frozen normal draw shared across calls
        (largegp.py:83-102 semantics: trajectory-consistent sampling)."""
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(1 << 31))
        d = self.system.obs_dim
        u = jax.random.normal(key, (d,))
        params = self.params

        def sampler(state, ctrl):
            mean_t, var_t = self._predictive(params, jnp.asarray(state), jnp.asarray(ctrl))
            draw = mean_t + jnp.sqrt(jnp.clip(var_t, 1e-12)) * u
            dy = draw * params["dy_std"] + params["dy_means"]
            return jnp.asarray(state) + dy

        return sampler

    # Reference-API aliases (largegp.py:141-207).
    def pred_parallel(self, states, ctrls):
        return self.pred_batch(states, ctrls)

    def pred_diff_parallel(self, states, ctrls):
        return self.pred_diff_batch(states, ctrls)

    def get_parameters(self):
        return {
            "gp_params": jax.tree_util.tree_map(np.array, self._params),
            "xu_means": np.array(self.xu_means),
            "xu_std": np.array(self.xu_std),
            "dy_means": np.array(self.dy_means),
            "dy_std": np.array(self.dy_std),
        }

    def set_parameters(self, params):
        self._params = jax.tree_util.tree_map(jnp.asarray, params["gp_params"])
        self.xu_means = jnp.asarray(params["xu_means"])
        self.xu_std = jnp.asarray(params["xu_std"])
        self.dy_means = jnp.asarray(params["dy_means"])
        self.dy_std = jnp.asarray(params["dy_std"])


# Reference-name alias (largegp.py:275).
LargeGaussianProcess = ApproximateGPModel


def gp_pred_core_cached(params, state, ctrl):
    """Pure cached-mean-weights GP predictor — the 'w' fast path of
    ``ApproximateGPModel.pred_core`` as a free function usable with
    per-lane parameter batches (fan-outs): one (M, d) kernel row per
    task, ``mean = mean_const + k(x, Z) @ w``. Padded dummy inducing
    rows (pad_inducing_params) contribute exact zeros."""
    xu = jnp.concatenate([state, ctrl])
    xut = (xu - params["xu_means"]) / params["xu_std"]
    gp = params["gp"]

    def one_mean(tp, w_t):
        k = _rbf(
            xut[None, :], tp["Z"],
            jnp.exp(tp["log_lengthscale"]),
            jnp.exp(tp["log_outputscale"]),
        )[0]
        return tp["mean_const"] + k @ w_t

    mean_t = jax.vmap(one_mean)(gp, params["w"])
    dy = mean_t * params["dy_std"] + params["dy_means"]
    return state + dy


def svgp_mean_weights(gp_params):
    """Cached mean-prediction weights ``w = Lz^{-T} v`` per task (the
    hoisted input-independent triangular solve of _task_predict)."""

    def task_w(tp):
        Z = tp["Z"]
        M = Z.shape[0]
        Kzz = _rbf(
            Z, Z, jnp.exp(tp["log_lengthscale"]),
            jnp.exp(tp["log_outputscale"]),
        ) + _JITTER * jnp.eye(M)
        Lz = jnp.linalg.cholesky(Kzz)
        return jax.scipy.linalg.solve_triangular(
            Lz, tp["m"], lower=True, trans=1
        )

    return jax.vmap(task_w)(gp_params)


def train_svgp_buckets(
    system, trajs, induce_counts, niter=5, lr=0.1, batch_size=1024,
    seed=100, pad_to=None,
):
    """Train one shared SVGP per DISTINCT induce_count — all buckets in
    ONE jitted device program.

    Every bucket trains at the padded shape ``pad_to`` (default
    max(induce_counts)) with exact no-op dummy inducing points
    (pad_inducing_params), the candidate-batch loss is the SUM of
    per-bucket ELBOs (gradients are independent, Adam is elementwise),
    and the data staging / init / PRNG chain match
    ``ApproximateGPModel.train`` exactly — so each bucket's result
    equals a standalone ``ApproximateGPModel(induce_count=M).train``
    with the same seed (pinned in tests/test_gp.py). This is what turns
    a wide induce_count sweep (the reference space is 50..200,
    largegp.py:343-348) from K sequential trainings into one program.

    Returns ``(params, w, norm)``: ``params`` — the per-bucket GP
    pytree with leading axis K (padded); ``w`` (K, n_task, pad_to) —
    cached mean weights; ``norm`` — dict of z-scoring stats shared by
    all buckets.
    """
    induce_counts = [int(m) for m in induce_counts]
    tb = traj_batch(trajs)
    mask = np.asarray(tb.step_mask())
    obs = np.asarray(tb.obs)
    ctrls = np.asarray(tb.ctrls)
    idx_b, idx_t = np.nonzero(mask)
    X = obs[idx_b, idx_t]
    U = ctrls[idx_b, idx_t]
    dY = obs[idx_b, idx_t + 1] - obs[idx_b, idx_t]
    XU = np.concatenate([X, U], axis=1)

    xu_means = jnp.asarray(XU.mean(axis=0))
    xu_std_np = XU.std(axis=0)
    xu_std = jnp.asarray(np.where(xu_std_np > 1e-12, xu_std_np, 1.0))
    dy_means = jnp.asarray(dY.mean(axis=0))
    dy_std_np = dY.std(axis=0)
    dy_std = jnp.asarray(np.where(dy_std_np > 1e-12, dy_std_np, 1.0))
    XUt = (jnp.asarray(XU) - xu_means) / xu_std
    dYt = (jnp.asarray(dY) - dy_means) / dy_std

    n_total, d = XUt.shape
    n_task = system.obs_dim
    pad_to = int(pad_to or max(min(m, n_total) for m in induce_counts))

    inits = []
    for M_req in induce_counts:
        M = min(M_req, n_total)
        p = {
            "Z": jnp.broadcast_to(XUt[:M], (n_task, M, d)),
            "log_lengthscale": jnp.zeros((n_task, d)),
            "log_outputscale": jnp.zeros((n_task,)),
            "log_noise": jnp.full((n_task,), np.log(0.1)),
            "mean_const": jnp.zeros((n_task,)),
            "m": jnp.zeros((n_task, M)),
            "Ls": jnp.broadcast_to(jnp.eye(M), (n_task, M, M)),
        }
        inits.append(pad_inducing_params(p, M, pad_to))
    params0 = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *inits
    )

    B = min(int(batch_size), n_total)
    nb = max(n_total // B, 1)
    n_used = nb * B
    opt = optax.adam(float(lr))
    opt_state = opt.init(params0)

    def task_slice(p, t):
        return {k: v[t] for k, v in p.items()}

    def loss_fn(p, xb, yb):
        def bucket_loss(pb):
            elbos = jnp.stack(
                [
                    _task_elbo(task_slice(pb, t), xb, yb[:, t], n_total)
                    for t in range(n_task)
                ]
            )
            return -jnp.sum(elbos)

        return jnp.sum(jax.vmap(bucket_loss)(p))

    key = jax.random.PRNGKey(int(seed))

    @jax.jit
    def train_all(params, opt_state, key):
        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, n_total)[:n_used]
            xb = XUt[perm].reshape(nb, B, d)
            yb = dYt[perm].reshape(nb, B, n_task)

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

        (params, _, _), losses = jax.lax.scan(
            epoch, (params, opt_state, key), None, length=int(niter)
        )
        return params, losses

    params, _ = train_all(params0, opt_state, key)
    w = jax.jit(jax.vmap(svgp_mean_weights))(params)
    norm = {
        "xu_means": xu_means, "xu_std": xu_std,
        "dy_means": dy_means, "dy_std": dy_std,
    }
    return params, w, norm
