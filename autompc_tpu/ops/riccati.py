"""Riccati recursions as XLA-native scans.

Replaces the reference's Python-loop Riccati iterations (reference:
autompc/control/lqr.py:15-47) and provides the time-varying backward pass
used by iLQR (ilqr.py:165-187) as a ``lax.scan``, plus an associative-scan
formulation that parallelizes the backward pass over the horizon
(sequence-dimension parallelism for the time axis; cf. SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def highest_precision(fn):
    """Trace ``fn`` under ``jax.default_matmul_precision("highest")``.

    On the GPU a float32 dot at default precision may run in TF32
    (about three decimal digits), which bends a 200-step Riccati
    recursion and the line search enough to cost convergence. The
    solvers' traced bodies (dynamics, cost expansions, recursion) are
    wrapped in this, so no quality gate depends on the platform's
    default."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def solve_small(A, b):
    """Linear solve specialized for the tiny control-dimension systems
    MPC produces: closed forms for 1x1/2x2 (a general LU lowers to a
    far more expensive kernel than a reciprocal), LU fallback
    otherwise."""
    n = A.shape[0]
    if n == 1:
        return b / A[0, 0]
    if n == 2:
        det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        inv = (
            jnp.array([[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]]) / det
        )
        return inv @ b
    return jnp.linalg.solve(A, b)


def dynamic_riccati_step(P, A, B, Q, R, N):
    """One step of the discrete-time dynamic Riccati equation
    (lqr.py:15-20 semantics)."""
    BtP = B.T @ P
    G = R + BtP @ B
    H = BtP @ A + N.T
    return A.T @ P @ A - (A.T @ P @ B + N) @ jnp.linalg.solve(G, H) + Q


def lqr_gain(A, B, P, R, N=None):
    """K = -(R + B'PB)^{-1} B'PA  (lqr.py:30-33, 44)."""
    BtP = B.T @ P
    rhs = BtP @ A if N is None else BtP @ A + N.T
    return -jnp.linalg.solve(R + BtP @ B, rhs)


def finite_horizon_lqr(A, B, Q, R, N, F, horizon: int):
    """Finite-horizon LQR gain.

    Reference semantics (lqr.py:35-47): start from P = F and apply the
    Riccati step ``horizon + 1`` times, then form the gain from the final
    P. Returns (K, P).
    """

    def body(_, P):
        return dynamic_riccati_step(P, A, B, Q, R, N)

    P = jax.lax.fori_loop(0, horizon + 1, body, F)
    return lqr_gain(A, B, P, R, N), P


def infinite_horizon_lqr(A, B, Q, R, N=None, threshold=1e-3, max_iter=10000):
    """Infinite-horizon LQR via Riccati fixed-point iteration.

    The reference's ``InfiniteHorizonLQR`` calls an undefined ``dare``
    (lqr.py:104 — broken); its ``_inf_horz_dt_lqr`` helper (lqr.py:22-33)
    defines the intended semantics: iterate until ``max|P1 - P2| <
    threshold``. Implemented here as a bounded ``while_loop``.
    """
    if N is None:
        N = jnp.zeros((A.shape[0], B.shape[1]), dtype=A.dtype)

    def cond(carry):
        P_prev, P, it = carry
        return (jnp.max(jnp.abs(P - P_prev)) > threshold) & (it < max_iter)

    def body(carry):
        _, P, it = carry
        return P, dynamic_riccati_step(P, A, B, Q, R, N), it + 1

    P0 = Q
    P1 = dynamic_riccati_step(P0, A, B, Q, R, N)
    _, P, _ = jax.lax.while_loop(cond, body, (P0, P1, jnp.array(0)))
    return lqr_gain(A, B, P, R, N), P


# ---------------------------------------------------------------------------
# Time-varying LQR backward pass (the iLQR inner recursion)
# ---------------------------------------------------------------------------


@highest_precision
def tvlqr_backward_scan(Jacs_x, Jacs_u, Cxx, Cuu, cx, cu, Vn, vn, unroll=1):
    """Sequential time-varying LQR backward pass as one ``lax.scan``.

    Mirrors the reference iLQR backward recursion (ilqr.py:165-187):
    at each step t (scanned in reverse),

      Qt = C_t + J_t' V J_t,   qt = c_t + J_t' v
      K_t = -Quu^{-1} Qux,     k_t = -Quu^{-1} qu
      V  <- Qxx + Qxu K + K' Qux + K' Quu K
      v  <- qx + Qxu k + K'(qu + Quu k)

    Parameters
    ----------
    Jacs_x : (H, ds, ds), Jacs_u : (H, ds, dc) dynamics Jacobians
    Cxx : (H, ds, ds), Cuu : (H, dc, dc) stage cost Hessians (dt-scaled)
    cx : (H, ds), cu : (H, dc) stage cost gradients (dt-scaled)
    Vn : (ds, ds), vn : (ds,) terminal value expansion

    Returns
    -------
    Ks : (H, dc, ds), ks : (H, dc), lin_red : scalar, quad_red : scalar
        Gains plus the accumulated expected linear/quadratic cost
        reductions used by the line-search acceptance test
        (ilqr.py:181-183, 208-214).
    """

    def step(carry, inp):
        V, v, lin_red, quad_red = carry
        Jx, Ju, Qx, Ru, qx, ru = inp
        # Q-function expansion blocks.
        JxV = Jx.T @ V
        JuV = Ju.T @ V
        Qxx = Qx + JxV @ Jx
        Quu = Ru + JuV @ Ju
        Qux = JuV @ Jx
        qx_t = qx + Jx.T @ v
        qu_t = ru + Ju.T @ v
        K = -solve_small(Quu, Qux)
        k = -solve_small(Quu, qu_t)
        lin_red = lin_red + qu_t @ k
        quad_red = quad_red + k @ Quu @ k
        V_new = Qxx + Qux.T @ K + K.T @ Qux + K.T @ Quu @ K
        v_new = qx_t + Qux.T @ k + K.T @ (qu_t + Quu @ k)
        return (V_new, v_new, lin_red, quad_red), (K, k)

    zero = jnp.zeros((), dtype=Vn.dtype)
    (V, v, lin_red, quad_red), (Ks, ks) = jax.lax.scan(
        step, (Vn, vn, zero, zero), (Jacs_x, Jacs_u, Cxx, Cuu, cx, cu),
        reverse=True, unroll=unroll,
    )
    return Ks, ks, lin_red, quad_red


# ---------------------------------------------------------------------------
# Parallel (associative-scan) time-varying LQR backward pass
# ---------------------------------------------------------------------------


def solve_unrolled(A, B):
    """Fixed-size linear solve by unrolled Gaussian elimination with
    partial pivoting — elementwise arithmetic, no LU custom call. For
    the tiny matrices MPC produces, inside a while_loop at large batch,
    an unrolled elimination avoids a batched LU library call per step.
    A (n, n), B (n, k)."""
    n = A.shape[0]
    M = jnp.concatenate([A, B], axis=1)          # (n, n+k)
    for col in range(n):
        # Partial pivot: swap the max-|.| row into place via a
        # permutation matrix (traceable, no dynamic slicing).
        rest = jnp.abs(M[col:, col])
        p = col + jnp.argmax(rest)
        rows = jnp.arange(n)
        perm = jnp.where(rows == col, p, jnp.where(rows == p, col, rows))
        M = M[perm]
        pivot = M[col, col]
        factor = M[:, col] / pivot
        elim = jnp.where(rows == col, 0.0, factor)
        M = M - elim[:, None] * M[col][None, :]
        M = M.at[col].set(M[col] / pivot)
    return M[:, n:]


# ---------------------------------------------------------------------------
# Element algebra of the parallel Riccati recursion — shared by the
# single-device associative scan (tvlqr_backward_assoc) and the
# cross-shard block-parallel backward (parallel/horizon.py). Elements
# are 5-tuples (A, b, C, eta, J); see tvlqr_backward_assoc's docstring
# for the derivation.
# ---------------------------------------------------------------------------


def tvlqr_element(Jx, Ju, Q, R, q, r, d, reg=0.0):
    """Per-step element. Sign convention: the value map uses
    ``(v + V b)`` with ``b = d - Ju (R + reg)^{-1} r``."""
    dc = Ju.shape[1]
    eye_u = jnp.eye(dc, dtype=Jx.dtype)
    Rt = R + reg * eye_u
    RiJu = solve_small(Rt, Ju.T)               # (dc, ds)
    C = Ju @ RiJu                              # (ds, ds)
    b = d - Ju @ solve_small(Rt, r)            # (ds,)
    return Jx, b, C, q, Q


def tvlqr_identity_element(ds, dtype):
    """Identity of the combine monoid: composing with it (on either
    side) is a no-op."""
    return (
        jnp.eye(ds, dtype=dtype),
        jnp.zeros(ds, dtype=dtype),
        jnp.zeros((ds, ds), dtype=dtype),
        jnp.zeros(ds, dtype=dtype),
        jnp.zeros((ds, ds), dtype=dtype),
    )


def tvlqr_combine(earlier, later):
    """Compose two elements; ``earlier`` is earlier in time (the
    composed element applies the later map first)."""
    Ai, bi, Ci, etai, Ji = earlier
    Aj, bj, Cj, etaj, Jj = later
    ds = Ai.shape[0]
    eye = jnp.eye(ds, dtype=Ai.dtype)
    D = solve_unrolled(eye + Ci @ Jj, eye)
    Dt = solve_unrolled(eye + Jj @ Ci, eye)
    A = Aj @ D @ Ai
    C = Aj @ D @ Ci @ Aj.T + Cj
    b = Aj @ D @ (bi - Ci @ etaj) + bj
    eta = Ai.T @ Dt @ (etaj + Jj @ bi) + etai
    J = Ai.T @ Dt @ Jj @ Ai + Ji
    return A, b, C, eta, J


def tvlqr_apply_element(elem, Vn, vn):
    """Apply a (suffix-composed) element to the terminal expansion,
    producing the value expansion (V_t, v_t) at the element's start."""
    A, b, C, eta, J = elem
    ds = A.shape[0]
    eye = jnp.eye(ds, dtype=A.dtype)
    WM = solve_unrolled(
        eye + Vn @ C,
        jnp.concatenate([Vn, (vn + Vn @ b)[:, None]], axis=1),
    )
    W, Mv = WM[:, :ds], WM[:, ds]
    return J + A.T @ W @ A, eta + A.T @ Mv


def tvlqr_gains(Jx, Ju, R, r, d, V, v, reg=0.0):
    """Pointwise gains from the NEXT-step value expansion; returns
    (K, k, lin_term, quad_term)."""
    dc = Ju.shape[1]
    eye_u = jnp.eye(dc, dtype=Jx.dtype)
    v_eff = v + V @ d
    JuV = Ju.T @ V
    Quu = R + reg * eye_u + JuV @ Ju
    Qux = JuV @ Jx
    qu = r + Ju.T @ v_eff
    K = -solve_small(Quu, Qux)
    k = -solve_small(Quu, qu)
    return K, k, qu @ k, k @ Quu @ k


@highest_precision
def tvlqr_backward_assoc(Jacs_x, Jacs_u, Cxx, Cuu, cx, cu, Vn, vn,
                         d_seq=None, reg=0.0):
    """Parallel-in-time TVLQR backward pass: O(log H) depth via
    ``lax.associative_scan`` (sequence-dimension parallelism over the
    MPC horizon; SURVEY §5 "long-context" mapping, cf. PAPERS.md
    "The Parallelization of Riccati Recursion").

    ``d_seq``/``reg`` extend the recursion to the multiple-shooting
    trajectory-QP form with dynamics defects and Levenberg
    regularization (ops/trajqp.py:qp_backward with Cux = 0): defects
    enter the value linear term as ``v_eff = v + V d``, which in the
    element algebra just shifts the affine part to
    ``b = d - Ju (Cuu + reg)^{-1} cu``.

    The value recursion of ``tvlqr_backward_scan`` is, in closed form,

        V_t = Q + F'(I + V C)^{-1} V F
        v_t = q + F'(I + V C)^{-1} (v - V b)

    with F = Jx, Q = Cxx, q = cx, C = Ju Cuu^{-1} Ju',
    b = Ju Cuu^{-1} cu, and (V, v) the time-t+1 value expansion. Maps of
    this 5-tuple family (A=F, b, C, eta=q, J=Q) are closed under
    composition:

        D  = (I + C_i J_j)^{-1},  Dt = (I + J_j C_i)^{-1}
        A  = A_j D A_i            C   = A_j D C_i A_j' + C_j
        b  = A_j D (b_i + C_i eta_j) + b_j
        eta= A_i' Dt (eta_j - J_j b_i) + eta_i
        J  = A_i' Dt J_j A_i + J_i

    (i earlier in time than j; the composed element applies the later
    map first). Suffix compositions of the per-step elements give every
    (V_t, v_t) at once; gains/expected-reductions are then pointwise.

    Requires Cuu invertible (true for the quadratic costs the tuner
    emits: R diagonal >= 1e-3, costs/quad_cost_factory.py). Matches
    ``tvlqr_backward_scan`` to f32 reassociation; exact in f64.
    """
    H, ds, dc = Jacs_u.shape
    if d_seq is None:
        d_seq = jnp.zeros((H, ds), dtype=Vn.dtype)

    elems = jax.vmap(lambda *a: tvlqr_element(*a, reg=reg))(
        Jacs_x, Jacs_u, Cxx, Cuu, cx, cu, d_seq
    )
    suffix = tvlqr_suffix_scan(elems)

    V_all, v_all = jax.vmap(
        lambda *e: tvlqr_apply_element(e, Vn, vn)
    )(*suffix)                                          # t = 0..H-1
    V_next = jnp.concatenate([V_all[1:], Vn[None]], axis=0)
    v_next = jnp.concatenate([v_all[1:], vn[None]], axis=0)

    Ks, ks, lin_t, quad_t = jax.vmap(
        lambda *a: tvlqr_gains(*a, reg=reg)
    )(Jacs_x, Jacs_u, Cuu, cu, d_seq, V_next, v_next)
    return Ks, ks, jnp.sum(lin_t), jnp.sum(quad_t)


def tvlqr_suffix_scan(elems):
    """Suffix compositions E_t = e_t (*) e_{t+1} (*) ... (*) e_{H-1}
    via ``lax.associative_scan``. Flips time via a gather (NOT
    reverse=True / jnp.flip: the Reverse HLO trips an XLA-CPU
    AlgebraicSimplifier check-failure when this runs inside
    vmap+while_loop), scans forward, and unflips; after the flip the
    accumulated first combine argument is the LATER-in-time block, so
    the arguments swap into combine's (earlier, later) signature."""
    H = elems[0].shape[0]
    idx = jnp.arange(H - 1, -1, -1)
    flip = lambda x: jnp.take(x, idx, axis=0)
    flipped = jax.tree_util.tree_map(flip, elems)
    suffix_flipped = jax.lax.associative_scan(
        jax.vmap(lambda a, b: tvlqr_combine(b, a)), flipped
    )
    return jax.tree_util.tree_map(flip, suffix_flipped)


# ---------------------------------------------------------------------------
# Parallel (associative-scan) linear rollout
# ---------------------------------------------------------------------------


def affine_rollout_scan(A_seq, b_seq, x0):
    """Roll ``x_{t+1} = A_t x_t + b_t`` sequentially. Returns (H+1, ds)."""

    def step(x, inp):
        A, b = inp
        x1 = A @ x + b
        return x1, x1

    _, xs = jax.lax.scan(step, x0, (A_seq, b_seq))
    return jnp.concatenate([x0[None], xs], axis=0)


def affine_rollout_parallel(A_seq, b_seq, x0):
    """Parallel-prefix rollout of an affine recursion via
    ``lax.associative_scan`` over composition of affine maps
    ``(A2,b2) ∘ (A1,b1) = (A2 A1, A2 b1 + b2)``.

    Exact for affine dynamics (LQR/ARX/Koopman rollouts and the iLQR
    forward pass on linearized dynamics); O(log H) depth instead of O(H).
    """

    def combine(f, g):
        A1, b1 = f
        A2, b2 = g
        return A2 @ A1, A2 @ b1 + b2

    # associative_scan combines along the leading axis; vmap the pairwise
    # combine over the batched prefix elements it passes in.
    As, bs = jax.lax.associative_scan(
        jax.vmap(combine), (A_seq, b_seq)
    )
    xs = jnp.einsum("tij,j->ti", As, x0) + bs
    return jnp.concatenate([x0[None], xs], axis=0)
