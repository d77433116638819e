"""Device-resident regression kernels.

These replace the native libraries the reference delegates regression to:
numpy lstsq (reference: autompc/sysid/arx.py:115), pysindy's STLSQ
(sindy.py:151-166), scikit-learn Lasso (koopman.py:150-156, sindy.py:5),
and scipy pinv2 (koopman.py:147). All are pure jax functions with static
iteration counts, so they jit and fuse into larger training programs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lstsq(A, y, rcond=None):
    """Least-squares solve via SVD (jnp.linalg.lstsq returns extras)."""
    sol, _, _, _ = jnp.linalg.lstsq(A, y, rcond=rcond)
    return sol


def masked_lstsq(A, y, mask, rcond=None, l2_reg=0.0):
    """Least squares over the rows of (A, y) selected by ``mask``.

    Invalid rows are zeroed on both sides so they contribute no residual —
    this keeps the shapes static under jit (a boolean gather would not).
    Optional tiny Tikhonov term stabilizes rank-deficient problems in f32.
    """
    mask = mask.astype(A.dtype)[:, None]
    Am = A * mask
    ym = y * (mask if y.ndim == 2 else mask[:, 0])
    if l2_reg > 0.0:
        # Solve the regularized normal equations without forming A^T A
        # explicitly: augment with sqrt(reg) * I rows.
        d = A.shape[1]
        Am = jnp.concatenate([Am, jnp.sqrt(l2_reg) * jnp.eye(d, dtype=A.dtype)])
        pad = jnp.zeros((d,) + y.shape[1:], dtype=y.dtype)
        ym = jnp.concatenate([ym, pad])
    return lstsq(Am, ym, rcond=rcond)


def pinv(A, rcond=1e-15):
    """Moore-Penrose pseudo-inverse (replaces scipy pinv2,
    koopman.py:147)."""
    return jnp.linalg.pinv(A, rcond=rcond)


def stlsq(A, y, threshold, n_iters=10, mask=None):
    """Sequentially-thresholded least squares (SINDy's STLSQ optimizer,
    replacing pysindy; reference usage sindy.py:151-166).

    Iterates: solve masked lstsq -> zero coefficients with
    ``|coef| < threshold`` -> re-solve restricted to the active support.
    The support is a multiplicative 0/1 mask so the iteration count is
    static and the whole solve jits.

    Parameters
    ----------
    A : (N, d) feature matrix
    y : (N, k) targets
    threshold : STLSQ cut
    n_iters : fixed iteration budget (reference pysindy default max_iter=20;
        support stabilizes in a few rounds)
    mask : optional (N,) row validity mask

    Returns
    -------
    coefs : (d, k) sparse coefficient matrix
    """
    if y.ndim == 1:
        y = y[:, None]
    N, d = A.shape
    k = y.shape[1]
    if mask is not None:
        rmask = mask.astype(A.dtype)[:, None]
        A = A * rmask
        y = y * rmask

    def solve_with_support(support):
        # support: (d, k) 0/1. Solve per-target masked columns.
        def solve_col(sup_col, y_col):
            Am = A * sup_col[None, :]
            # Ridge epsilon keeps pruned columns from polluting the SVD.
            sol = lstsq(Am, y_col)
            return sol * sup_col

        return jax.vmap(solve_col, in_axes=(1, 1), out_axes=1)(support, y)

    def body(_, carry):
        coefs, support = carry
        coefs = solve_with_support(support)
        support = (jnp.abs(coefs) >= threshold).astype(A.dtype)
        coefs = coefs * support
        return coefs, support

    support0 = jnp.ones((d, k), dtype=A.dtype)
    coefs0 = jnp.zeros((d, k), dtype=A.dtype)
    coefs, support = jax.lax.fori_loop(0, n_iters, body, (coefs0, support0))
    # Final re-fit on the converged support.
    coefs = solve_with_support(support)
    return coefs


def stlsq_gram(G, b, threshold, n_iters=10, ridge=1e-7):
    """STLSQ on precomputed NORMAL EQUATIONS: ``G = A'A`` (d, d),
    ``b = A'y`` (d, k).

    Same iteration as ``stlsq`` — solve on the active support, zero
    ``|coef| < threshold``, re-solve — but each masked solve is a
    (d, d) linear system instead of an (N, d) SVD. The joint tuning
    fan-out trains HUNDREDS of candidate lanes against the SAME staged
    data matrix (only the threshold varies per lane), so G/b stage once
    and the per-lane cost drops from O(N d^2) SVDs to O(d^3) solves
    (tools/profile_joint_fanout.py times the phases).

    Support masking zeroes the pruned rows/columns of G and puts 1 on
    their diagonal (with the right-hand side masked, pruned coords
    solve to exactly 0). Each masked system is Jacobi-preconditioned
    (scaled to unit diagonal, D^-1/2 G D^-1/2): feature libraries mix
    wildly different column scales (trig vs poly powers), and the
    scaling tames most of the squared conditioning the normal
    equations introduce in f32; ``ridge`` is then relative to the unit
    diagonal. The scaled system is SPD, so the solve is CHOLESKY + two
    triangular solves, cheaper than LU for the batched (55, 55) shape.
    A lane whose masked Gram loses positive-definiteness
    despite scaling + ridge produces NaNs -> an empty support -> zero
    coefficients, which downstream scores the candidate ``inf`` (the
    bad-config contract, reference pipeline_tuner.py:236-239).

    Returns (d, k) coefficients — matches ``stlsq`` up to conditioning
    (pinned by tests/test_sindy_ilqr.py's gram-vs-svd tests, incl. an
    ill-conditioned poly+trig library staged in f32).
    """
    if b.ndim == 1:
        b = b[:, None]
    d = G.shape[0]
    gdiag = jnp.diag(G)

    def solve_with_support(support):
        def solve_col(sup, b_col):
            # Jacobi scaling s = 1/sqrt(diag) on the active set; s = 0
            # on pruned coords (their rows/cols drop, diag pinned to 1).
            s = jnp.where(
                sup > 0, 1.0 / jnp.sqrt(jnp.maximum(gdiag, 1e-30)), 0.0
            )
            Gs = (s[:, None] * G * s[None, :])
            Gs = Gs + jnp.diag((1.0 - sup) + ridge * sup)
            L = jnp.linalg.cholesky(Gs)
            y_ = jax.scipy.linalg.solve_triangular(
                L, b_col * s, lower=True
            )
            sol = jax.scipy.linalg.solve_triangular(
                L.T, y_, lower=False
            )
            return sol * s

        return jax.vmap(solve_col, in_axes=(1, 1), out_axes=1)(support, b)

    # Early-stopping iteration: once the support is unchanged, further
    # rounds re-solve the same system (a fixed point), so stopping is
    # RESULT-IDENTICAL to the fixed n_iters loop — and the support
    # typically stabilizes in ~3 rounds, not 10. Under vmap the
    # while_loop runs to the slowest lane, still far under n_iters.
    def cond(carry):
        _, changed, it = carry
        return changed & (it < n_iters)

    def body(carry):
        support, _, it = carry
        coefs = solve_with_support(support)
        new_support = (jnp.abs(coefs) >= threshold).astype(G.dtype)
        changed = jnp.any(new_support != support)
        return new_support, changed, it + 1

    support0 = jnp.ones(b.shape, dtype=G.dtype)
    support, _, _ = jax.lax.while_loop(
        cond, body, (support0, jnp.array(True), jnp.array(0))
    )
    return solve_with_support(support)


def gram_stage(A, y, mask=None):
    """(G, b) = (A'A, A'y) with optional row masking — the staging step
    for ``stlsq_gram`` (one pass over the data, shared across every
    candidate lane)."""
    if y.ndim == 1:
        y = y[:, None]
    if mask is not None:
        rmask = mask.astype(A.dtype)[:, None]
        A = A * rmask
        y = y * rmask
    return A.T @ A, A.T @ y


def soft_threshold(x, thresh):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - thresh, 0.0)


def fista_lasso(A, y, alpha, n_iters=200, mask=None):
    """FISTA proximal-gradient Lasso (replaces sklearn.linear_model.Lasso;
    reference usage koopman.py:150-156).

    Minimizes ``1/(2N) ||A w - y||^2 + alpha ||w||_1`` per target column
    (sklearn's objective scaling), with a fixed iteration budget so the
    solve jits.

    Returns (d, k) coefficients.
    """
    if y.ndim == 1:
        y = y[:, None]
    if mask is not None:
        rmask = mask.astype(A.dtype)[:, None]
        A = A * rmask
        y = y * rmask
    N = jnp.maximum(jnp.sum(mask) if mask is not None else A.shape[0], 1.0)
    # Lipschitz constant of the smooth part: ||A||_2^2 / N (power iteration).
    def power_iter(_, v):
        v = A.T @ (A @ v)
        return v / (jnp.linalg.norm(v) + 1e-30)

    v0 = jnp.ones((A.shape[1],), dtype=A.dtype) / jnp.sqrt(A.shape[1])
    v = jax.lax.fori_loop(0, 30, power_iter, v0)
    L = jnp.vdot(v, A.T @ (A @ v)) / N + 1e-12
    step = 1.0 / L

    AtA = (A.T @ A) / N
    Aty = (A.T @ y) / N

    def body(_, carry):
        w, z, t = carry
        grad = AtA @ z - Aty
        w_next = soft_threshold(z - step * grad, step * alpha)
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        z_next = w_next + ((t - 1.0) / t_next) * (w_next - w)
        return w_next, z_next, t_next

    w0 = jnp.zeros((A.shape[1], y.shape[1]), dtype=A.dtype)
    w, _, _ = jax.lax.fori_loop(0, n_iters, body, (w0, w0, jnp.array(1.0, A.dtype)))
    return w
