"""Pallas kernel (Triton route): batched dc=1 iLQR backward pass with
inline diagonal-quadratic stage expansions.

The iLQR backward recursion (ops/riccati.py:tvlqr_backward_scan) is a
chain of H sequential steps of tiny (ds x ds) algebra per lane. Under
``vmap(lax.scan)`` XLA runs every step as its own handful of small
kernels, so at H=200 the pass is bound by launches and latency, not by
the few MB it moves. This kernel is one launch per backward pass:

* one program owns a block of batch lanes, one lane per thread;
  every (i, j) matrix entry is a (TB,) vector over the block's lanes,
  so the algebra is elementwise and the control dimension is
  specialized to dc=1 (the Quu solve is a reciprocal);
* the horizon is a ``fori_loop`` inside the program, with the value
  function V, v in registers;
* inputs are read straight from the solver's batch-major carry and the
  stage expansions of the diagonal QuadCost (value (x-g)'Q(x-g),
  gradient 2Q(x-g), hessian 2Q, dt-scaled; costs/cost.py:62-141) are
  computed inline from (xs, us), so no (B, H, ds, ds) expansion array
  is materialized.

Correctness is pinned to ``tvlqr_backward_scan`` by tests (interpret
mode on the CPU) and by ``chip_smoke.py`` on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Lanes per program. One warp per program: at the compaction-shrunk
# batch sizes the solver reaches, small programs spread the lanes over
# more SMs.
BLOCK_B = 32
NUM_WARPS = 1


def pad_batch(arrays, block):
    """Pad every array's leading (batch) axis to a multiple of
    ``block`` by repeating the last lane; returns (padded, B)."""
    B = arrays[0].shape[0]
    pad = (-B) % block
    if pad == 0:
        return list(arrays), B
    return [
        jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)], axis=0)
        for a in arrays
    ], B


def block_for(B):
    """Power-of-two lane block for a batch of ``B`` (Triton block
    shapes are powers of two)."""
    return min(BLOCK_B, 1 << max(0, (B - 1).bit_length()))


def bq_step(ds, obsdim, Jx, Ju, cx, cu, rd2, qd, V, v):
    """One diagonal-quad backward step on (TB,) lane vectors. ``Jx`` and
    ``V`` are nested [k][j] lists, ``Ju``/``cx``/``qd``/``v`` lists.
    Returns (K, kff, V_new, v_new, dlin, dquad) as lists/vectors."""
    JuV = [sum(Ju[k] * V[k][j] for k in range(ds)) for j in range(ds)]
    Quu = rd2 + sum(JuV[k] * Ju[k] for k in range(ds))
    inv_quu = 1.0 / Quu
    Qux = [sum(JuV[k] * Jx[k][j] for k in range(ds)) for j in range(ds)]
    qu = cu + sum(Ju[k] * v[k] for k in range(ds))
    K = [-Qux[j] * inv_quu for j in range(ds)]
    kff = -qu * inv_quu
    JxV = [
        [sum(Jx[k][i] * V[k][j] for k in range(ds)) for j in range(ds)]
        for i in range(ds)
    ]
    # Qxx = diag(2 Q dt) + Jx' V Jx; V' = Qxx + Qux'K + K'Qux + K'Quu K.
    V_new = [
        [
            sum(JxV[i][k] * Jx[k][j] for k in range(ds))
            + (qd[i] if (i == j and i < obsdim) else 0.0)
            + Qux[i] * K[j] + K[i] * Qux[j] + K[i] * K[j] * Quu
            for j in range(ds)
        ]
        for i in range(ds)
    ]
    qx = [cx[i] + sum(Jx[k][i] * v[k] for k in range(ds)) for i in range(ds)]
    resid = qu + Quu * kff
    v_new = [qx[i] + Qux[i] * kff + K[i] * resid for i in range(ds)]
    return K, kff, V_new, v_new, qu * kff, kff * Quu * kff


def _backward_quad_kernel(ds, obsdim, H, dt,
                          jx_ref, ju_ref, xs_ref, us_ref,
                          qd_ref, rd_ref, fd_ref, goal_ref,
                          ks_ref, kv_ref, lin_ref, quad_ref):
    """Block shapes (batch-major, TB lanes): jx (TB, H, ds, ds),
    ju (TB, H, ds, 1), xs (TB, H+1, ds), us (TB, H, 1),
    qd/fd (TB, obsdim), rd (TB, 1), goal (obsdim,);
    outs Ks (TB, H, 1, ds), ks (TB, H, 1), lin/quad (TB,)."""
    qd = [qd_ref[:, i] * (2.0 * dt) for i in range(obsdim)]
    rd2 = rd_ref[:, 0] * (2.0 * dt)
    goal = [goal_ref[i] for i in range(obsdim)]
    zero = jnp.zeros_like(rd2)

    # Terminal expansion: Vn = diag(2 F), vn = 2 F (x_H - g).
    fd2 = [fd_ref[:, i] * 2.0 for i in range(obsdim)]
    V0 = tuple(
        fd2[i] if (i == j and i < obsdim) else zero
        for i in range(ds) for j in range(ds)
    )
    v0 = tuple(
        fd2[i] * (xs_ref[:, H, i] - goal[i]) if i < obsdim else zero
        for i in range(ds)
    )

    def body(n, carry):
        t = H - 1 - n
        Vf, v, lin, quad = carry
        V = [list(Vf[k * ds:(k + 1) * ds]) for k in range(ds)]
        Jx = [[jx_ref[:, t, k, j] for j in range(ds)] for k in range(ds)]
        Ju = [ju_ref[:, t, k, 0] for k in range(ds)]
        cx = [
            qd[i] * (xs_ref[:, t, i] - goal[i]) if i < obsdim else zero
            for i in range(ds)
        ]
        cu = rd2 * us_ref[:, t, 0]
        K, kff, V_new, v_new, dlin, dquad = bq_step(
            ds, obsdim, Jx, Ju, cx, cu, rd2, qd, V, list(v)
        )
        for j in range(ds):
            ks_ref[:, t, 0, j] = K[j]
        kv_ref[:, t, 0] = kff
        return (
            tuple(e for row in V_new for e in row), tuple(v_new),
            lin + dlin, quad + dquad,
        )

    _, _, lin, quad = jax.lax.fori_loop(0, H, body, (V0, v0, zero, zero))
    lin_ref[...] = lin
    quad_ref[...] = quad


@functools.partial(jax.jit, static_argnames=("dt", "obsdim", "interpret"))
def pallas_tvlqr_backward_quad(
    Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, dt, obsdim,
    interpret: bool = False,
):
    """Batched backward pass with inline diagonal-quadratic expansions;
    dc must be 1.

    Parameters: Jx (B, H, ds, ds), Ju (B, H, ds, 1), xs (B, H+1, ds),
    us (B, H, 1), Qdiag/Fdiag (B, obsdim), Rdiag (B, 1), goal
    (obsdim,); dt and obsdim static.

    Returns (Ks (B, H, 1, ds), ks (B, H, 1), lin_red (B,), quad_red
    (B,)), the outputs of ``tvlqr_backward_scan`` fed the QuadCost stage
    expansions.
    """
    B, H, ds, _ = Jx.shape
    if Ju.shape[-1] != 1:
        raise ValueError("pallas_tvlqr_backward_quad is dc=1 only")
    dtype = Jx.dtype
    TB = block_for(B)
    (Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag), _ = pad_batch(
        [Jx, Ju, xs, us, Qdiag.astype(dtype), Rdiag.astype(dtype),
         Fdiag.astype(dtype)],
        TB,
    )
    Bp = Jx.shape[0]

    def bspec(shape):
        nd = len(shape)
        return pl.BlockSpec(
            (TB,) + shape, lambda i, nd=nd: (i,) + (0,) * nd
        )

    Ks, ks, lin, quad = pl.pallas_call(
        functools.partial(_backward_quad_kernel, ds, obsdim, H, float(dt)),
        grid=(Bp // TB,),
        in_specs=[
            bspec((H, ds, ds)), bspec((H, ds, 1)), bspec((H + 1, ds)),
            bspec((H, 1)), bspec((obsdim,)), bspec((1,)),
            bspec((obsdim,)),
            pl.BlockSpec((obsdim,), lambda i: (0,)),
        ],
        out_specs=(
            bspec((H, 1, ds)), bspec((H, 1)), bspec(()), bspec(()),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((Bp, H, 1, ds), dtype),
            jax.ShapeDtypeStruct((Bp, H, 1), dtype),
            jax.ShapeDtypeStruct((Bp,), dtype),
            jax.ShapeDtypeStruct((Bp,), dtype),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="ilqr_backward_quad",
    )(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag,
      jnp.asarray(goal, dtype=dtype).reshape(obsdim))
    return Ks[:B], ks[:B], lin[:B], quad[:B]
