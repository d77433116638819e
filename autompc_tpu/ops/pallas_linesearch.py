"""Pallas kernel (Triton route): the fused iLQR line search for models
linear in features.

The line search rolls all ``L`` step sizes of every lane through the
dynamics for the whole horizon. The XLA path (``vmap(lax.scan)`` over
alphas and lanes, control/ilqr.py) runs H sequential small steps and
writes the whole (B, L, H+1, ds) candidate window to device memory, then
reads it back to evaluate objectives and select. This kernel keeps the
rollout in registers:

* one program owns a block of TB batch lanes; the alphas are a second
  block axis, padded to a power of two, so each state component is an
  (Lp, TB) slab and the horizon is a ``fori_loop`` inside the program;
* pass 1 rolls every alpha and accumulates the quadratic objective
  ``dt * sum((x-g)'Q(x-g) + u'Ru) + (x_H-g)'F(x_H-g)`` in registers;
* the reference acceptance rule (autompc/control/ilqr.py:208-233: the
  first alpha passing the expected-reduction test, else the objective
  argmin, with the worsens-by-more-than-1e-3 failure case) runs on the
  (Lp, TB) objectives;
* pass 2 re-rolls only the selected alpha and writes the accepted
  trajectory and, when the library has analytic term gradients
  (``FeatureLibrary.grad_terms``), the dynamics Jacobians along it, so
  the relinearization phase needs no separate pass.

The model must be linear in features with per-scalar term functions
(discrete-time SINDy/Koopman form ``x' = coeffs @ theta(x, u)``): the
library's term functions are traced directly over the slabs. Inputs and
outputs use the solver's batch-major layout.

Correctness is pinned to the XLA line search by tests (interpret mode on
the CPU) and by ``chip_smoke.py`` on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .pallas_riccati import pad_batch

# Lanes per program and warps per program: a program's slabs are
# (Lp, BLOCK_B) = (16, 32) at the reference's 10 alphas.
BLOCK_B = 32
NUM_WARPS = 4


def tree_sum(vals):
    """Balanced summation: a sequential left fold over ~55 float32 terms
    loses enough precision to visibly change iLQR convergence."""
    vals = list(vals)
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


class _VecZ:
    """Component-indexed virtual input: term functions written against a
    vector ``z`` (z[i] -> scalar) evaluate over lane slabs."""

    def __init__(self, comps):
        self._comps = comps

    def __getitem__(self, i):
        return self._comps[i]


def _fused_kernel(term_fns, grad_terms, ds, dc, obsdim, H, L, dt,
                  ls_thresh, diag_cost, per_lane_coeffs, has_reg, *refs):
    """Block shapes (batch-major, TB lanes):
    x0 (TB, ds), xs (TB, H+1, ds), us (TB, H, dc), Ks (TB, H, dc, ds),
    ks (TB, H, dc), coeffs (ds, F) or per lane (TB, ds, F),
    umin/umax (dc,), alphas/lidx (Lp,),
    Q/F (TB, obsdim) and R (TB, dc) when ``diag_cost`` else shared
    (obsdim, obsdim)/(dc, dc), goal (obsdim,),
    obj0/lin/quad/ks_small (TB,) [+ regS (obsdim, obsdim), regmu
    (obsdim,), regw (TB,)];
    outs xs (TB, H+1, ds), us (TB, H, dc), obj/succ/fail (TB,)
    [+ Jx (TB, H, ds, ds), Ju (TB, H, ds, dc)]."""
    (x0_ref, xs_ref, us_ref, Ks_ref, ks_ref, coeffs_ref, umin_ref,
     umax_ref, alpha_ref, lidx_ref, Q_ref, R_ref, F_ref, goal_ref,
     obj0_ref, lin_ref, quad_ref, kssmall_ref) = refs[:18]
    n_in = 18
    if has_reg:
        regS_ref, regmu_ref, regw_ref = refs[18:21]
        n_in = 21
    (out_xs_ref, out_us_ref, out_obj_ref, out_succ_ref,
     out_fail_ref) = refs[n_in:n_in + 5]
    if grad_terms is not None:
        jx_ref, ju_ref = refs[n_in + 5:n_in + 7]

    n_feat = coeffs_ref.shape[-1]
    alpha_col = alpha_ref[...][:, None]                 # (Lp, 1)
    lidx = lidx_ref[...][:, None]                       # (Lp, 1)
    umin = [umin_ref[j] for j in range(dc)]
    umax = [umax_ref[j] for j in range(dc)]
    goal = [goal_ref[i] for i in range(obsdim)]
    if diag_cost:
        Qd = [Q_ref[:, i] for i in range(obsdim)]
        Rd = [R_ref[:, j] for j in range(dc)]
        Fd = [F_ref[:, i] for i in range(obsdim)]
    if not per_lane_coeffs:
        cf = [[coeffs_ref[i, k] for k in range(n_feat)] for i in range(ds)]
    if has_reg:
        regmu = [regmu_ref[i] for i in range(obsdim)]
        regw = regw_ref[...]

    def coeffs():
        if per_lane_coeffs:
            return [[coeffs_ref[:, i, k] for k in range(n_feat)]
                    for i in range(ds)]
        return cf

    def quad_form(vec, diag, M_ref, n):
        if diag_cost:
            return tree_sum([diag[i] * vec[i] * vec[i] for i in range(n)])
        return tree_sum([M_ref[i, j] * vec[i] * vec[j]
                         for i in range(n) for j in range(n)])

    def controls(x, t, alpha):
        """Feedback law + clip: u_j = alpha k_j + ubar_j + K_j.(x - xbar)."""
        dx = [x[i] - xs_ref[:, t, i] for i in range(ds)]
        u = []
        for j in range(dc):
            fb = tree_sum([Ks_ref[:, t, j, i] * dx[i] for i in range(ds)])
            uj = alpha * ks_ref[:, t, j] + us_ref[:, t, j] + fb
            u.append(jnp.minimum(jnp.maximum(uj, umin[j]), umax[j]))
        return u

    def step_dynamics(x, u, c):
        theta = [fn(_VecZ(x + u)) for fn in term_fns]
        return [tree_sum([c[i][k] * theta[k] for k in range(n_feat)])
                for i in range(ds)]

    # ---- pass 1: every alpha, objective only ----------------------------
    zero_slab = jnp.zeros_like(alpha_col * x0_ref[:, 0])   # (Lp, TB)
    x = tuple(zero_slab + x0_ref[:, i] for i in range(ds))

    def body1(t, carry):
        x = list(carry[:-1])
        obj = carry[-1]
        u = controls(x, t, alpha_col)
        dxg = [x[i] - goal[i] for i in range(obsdim)]
        oc = quad_form(dxg, Qd if diag_cost else None, Q_ref, obsdim)
        cc = quad_form(u, Rd if diag_cost else None, R_ref, dc)
        if has_reg:
            # S is symmetric: the upper triangle with 2x off-diagonal.
            dxm = [x[i] - regmu[i] for i in range(obsdim)]
            oc = oc + regw * tree_sum([
                (1.0 if i == j else 2.0) * regS_ref[i, j] * dxm[i] * dxm[j]
                for i in range(obsdim) for j in range(i, obsdim)
            ])
        x_new = step_dynamics(x, u, coeffs())
        return tuple(x_new) + (obj + dt * (oc + cc),)

    out1 = jax.lax.fori_loop(0, H, body1, x + (zero_slab,))
    dxg = [out1[i] - goal[i] for i in range(obsdim)]
    objs = out1[-1] + quad_form(dxg, Fd if diag_cost else None, F_ref,
                                obsdim)
    # Padded alphas never win.
    objs = jnp.where(lidx < L, objs, jnp.inf)

    # ---- acceptance rule on (Lp, TB) slabs ------------------------------
    obj0 = obj0_ref[...]
    ks_small = kssmall_ref[...] > 0.5
    denom = -(alpha_col * lin_ref[...]
              + alpha_col * alpha_col * quad_ref[...] * 0.5)
    ratio = jnp.where(jnp.abs(denom) > 1e-30, (obj0 - objs) / denom,
                      -jnp.inf)
    accept = (ratio > ls_thresh) & (lidx < L)
    first_acc = jnp.min(jnp.where(accept, lidx, float(L)), axis=0)
    any_acc = first_acc < L
    best_val = jnp.min(objs, axis=0)
    best_idx = jnp.min(jnp.where(objs == best_val, lidx, float(L)), axis=0)
    zerof = jnp.zeros_like(obj0)
    chosen = jnp.where(ks_small, zerof,
                       jnp.where(any_acc, first_acc, best_idx))
    idx_last = jnp.where(ks_small, zerof,
                         jnp.where(any_acc, first_acc, float(L - 1)))

    def pick(slab, idx):
        return jnp.sum(jnp.where(lidx == idx, slab, 0.0), axis=0)

    chosen_obj = pick(objs, chosen)
    last_obj = pick(objs, idx_last)
    ls_success = (chosen_obj < obj0) | ks_small
    failed = (~ls_success) & (last_obj > obj0 + 1e-3)
    sel = jnp.where(ls_success, chosen, idx_last)
    out_obj_ref[...] = jnp.where(ls_success, chosen_obj, last_obj)
    out_succ_ref[...] = ls_success.astype(obj0.dtype)
    out_fail_ref[...] = failed.astype(obj0.dtype)
    a_sel = pick(zero_slab + alpha_col, sel)            # (TB,)

    # ---- pass 2: re-roll the selected alpha -----------------------------
    x2 = tuple(x0_ref[:, i] for i in range(ds))
    for i in range(ds):
        out_xs_ref[:, 0, i] = x2[i]

    def body2(t, x2):
        x2 = list(x2)
        u = controls(x2, t, a_sel)
        c = coeffs()
        x_new = step_dynamics(x2, u, c)
        for i in range(ds):
            out_xs_ref[:, t + 1, i] = x_new[i]
        for j in range(dc):
            out_us_ref[:, t, j] = u[j]
        if grad_terms is not None:
            # Jacobian at (x_t, u_t): coeffs @ dTheta/dz, evaluating only
            # the terms with a nonzero partial w.r.t. each component.
            z = _VecZ(x2 + u)
            for dd in range(ds + dc):
                parts = [(k, g(z)) for k, entries in enumerate(grad_terms)
                         for (ci, g) in entries if ci == dd]
                for i in range(ds):
                    val = zerof + (
                        tree_sum([c[i][k] * g for k, g in parts])
                        if parts else 0.0
                    )
                    if dd < ds:
                        jx_ref[:, t, i, dd] = val
                    else:
                        ju_ref[:, t, i, dd - ds] = val
        return tuple(x_new)

    jax.lax.fori_loop(0, H, body2, x2)


@functools.partial(
    jax.jit,
    static_argnames=(
        "term_fns", "grad_terms", "alphas", "dt", "ls_cost_threshold",
        "diag_cost", "interpret",
    ),
)
def pallas_fused_line_search(
    term_fns, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax,
    Q, R, F, goal, dt, obj0, lin_red, quad_red, ks_small,
    grad_terms=None,
    ls_cost_threshold: float = 0.3,
    diag_cost: bool = False,
    reg=None,
    interpret: bool = False,
):
    """Fused line search for linear-in-features models and quadratic
    costs: rolls all alphas, evaluates the iLQR objective in registers,
    applies the reference acceptance rule and emits only the selected
    trajectory.

    Parameters: term_fns (the library's scalar term functions, static);
    x0 (B, ds), xs (B, H+1, ds), us (B, H, dc), Ks (B, H, dc, ds),
    ks (B, H, dc); coeffs (ds, F) shared or (B, ds, F) per lane;
    alphas (static tuple of step sizes); umin/umax (dc,).
    ``diag_cost=True``: Q/F (B, obsdim) and R (B, dc) per-lane diagonals
    (the QuadCostFactory candidate space); otherwise shared dense
    Q/F (obsdim, obsdim), R (dc, dc). goal (obsdim,); dt; obj0,
    lin_red, quad_red (B,): current objective and expected-reduction
    coefficients from the backward pass; ks_small (B,) bool: the
    ||k|| < tol fast-accept flag.

    ``reg``: optional ``(S (obsdim, obsdim), mu (obsdim,), w (B,))``
    adding the per-lane-weighted shared dense stage term
    ``w * (x - mu)' S (x - mu)`` (the GaussRegFactory term of SumCost
    candidates; S symmetric).

    ``grad_terms`` (optional, ``FeatureLibrary.grad_terms``): also emit
    the dynamics Jacobians along the accepted trajectory.

    Returns (new_xs (B, H+1, ds), new_us (B, H, dc), new_obj (B,),
    ls_success (B,) bool, failed (B,) bool)
    [+ (Jx (B, H, ds, ds), Ju (B, H, ds, dc)) when grad_terms is given].
    """
    B, Hp1, ds = xs.shape
    H = Hp1 - 1
    dc = us.shape[-1]
    obsdim = goal.shape[0]
    dtype = xs.dtype
    L = len(alphas)
    Lp = 1 << max(0, (L - 1).bit_length())
    TB = min(BLOCK_B, 1 << max(0, (B - 1).bit_length()))
    per_lane_coeffs = coeffs.ndim == 3

    lane = [x0, xs, us, Ks, ks]
    if per_lane_coeffs:
        lane.append(coeffs.astype(dtype))
    if diag_cost:
        lane += [Q.astype(dtype), R.astype(dtype), F.astype(dtype)]
    lane += [obj0.astype(dtype), lin_red.astype(dtype),
             quad_red.astype(dtype), ks_small.astype(dtype)]
    if reg is not None:
        lane.append(jnp.asarray(reg[2], dtype).reshape(B))
    lane, _ = pad_batch(lane, TB)
    Bp = lane[0].shape[0]
    lane = iter(lane)

    def lspec(a):
        nd = a.ndim - 1
        return pl.BlockSpec((TB,) + a.shape[1:],
                            lambda i, nd=nd: (i,) + (0,) * nd)

    def fspec(a):
        return pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)

    inputs, specs = [], []

    def add(a, per_lane):
        inputs.append(a)
        specs.append(lspec(a) if per_lane else fspec(a))

    for _ in range(5):
        add(next(lane), True)
    add(next(lane) if per_lane_coeffs else coeffs.astype(dtype),
        per_lane_coeffs)
    for bound in (umin, umax):
        add(jnp.broadcast_to(jnp.asarray(bound, dtype).reshape(-1), (dc,)),
            False)
    add(jnp.asarray(alphas + (0.0,) * (Lp - L), dtype), False)
    add(jnp.arange(Lp, dtype=dtype), False)
    if diag_cost:
        for _ in range(3):
            add(next(lane), True)
    else:
        for M in (Q, R, F):
            add(jnp.asarray(M, dtype), False)
    add(jnp.asarray(goal, dtype).reshape(obsdim), False)
    for _ in range(4):
        add(next(lane), True)
    if reg is not None:
        add(jnp.asarray(reg[0], dtype), False)
        add(jnp.asarray(reg[1], dtype).reshape(obsdim), False)
        add(next(lane), True)

    out_shape = [
        jax.ShapeDtypeStruct((Bp, H + 1, ds), dtype),
        jax.ShapeDtypeStruct((Bp, H, dc), dtype),
        jax.ShapeDtypeStruct((Bp,), dtype),
        jax.ShapeDtypeStruct((Bp,), dtype),
        jax.ShapeDtypeStruct((Bp,), dtype),
    ]
    if grad_terms is not None:
        out_shape += [
            jax.ShapeDtypeStruct((Bp, H, ds, ds), dtype),
            jax.ShapeDtypeStruct((Bp, H, ds, dc), dtype),
        ]
    kernel = functools.partial(
        _fused_kernel, term_fns, grad_terms, ds, dc, obsdim, H, L,
        float(dt), float(ls_cost_threshold), bool(diag_cost),
        per_lane_coeffs, reg is not None,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // TB,),
        in_specs=specs,
        out_specs=tuple(lspec(s) for s in out_shape),
        out_shape=tuple(out_shape),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="ilqr_fused_line_search",
    )(*inputs)
    outs = [o[:B] for o in outs]
    new_xs, new_us, obj, succ, fail = outs[:5]
    return (new_xs, new_us, obj, succ > 0.5, fail > 0.5) + tuple(outs[5:])
