"""Pallas (Triton route) backward-pass kernel vs the scan reference, in
interpret mode: the kernel's inline diagonal-quadratic expansions fed
to ``tvlqr_backward_scan`` as explicit (Cxx, Cuu, cx, cu, Vn, vn)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autompc_tpu.ops.pallas_riccati import (
    BLOCK_B,
    block_for,
    pad_batch,
    pallas_tvlqr_backward_quad,
)
from autompc_tpu.ops.riccati import tvlqr_backward_scan


def _inputs(B, H, ds, obsdim, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        Jx=jnp.asarray(np.eye(ds) + 0.1 * rng.normal(size=(B, H, ds, ds))),
        Ju=jnp.asarray(0.1 * rng.normal(size=(B, H, ds, 1))),
        xs=jnp.asarray(rng.normal(size=(B, H + 1, ds))),
        us=jnp.asarray(rng.normal(size=(B, H, 1))),
        Qd=jnp.asarray(rng.uniform(0.1, 2.0, (B, obsdim))),
        Rd=jnp.asarray(rng.uniform(0.1, 2.0, (B, 1))),
        Fd=jnp.asarray(rng.uniform(0.1, 2.0, (B, obsdim))),
        goal=jnp.asarray(rng.normal(size=obsdim)),
    )


def _reference(a, dt, obsdim):
    """vmap(tvlqr_backward_scan) on the QuadCost expansions."""
    B, H, ds, _ = a["Jx"].shape
    oi = jnp.arange(obsdim)

    def one(Jx, Ju, xs, us, Qd, Rd, Fd):
        dx = xs[:H, :obsdim] - a["goal"]
        cx = jnp.zeros((H, ds)).at[:, :obsdim].set(2 * dx * Qd * dt)
        Cxx = jnp.zeros((H, ds, ds)).at[:, oi, oi].set(
            jnp.broadcast_to(2 * Qd * dt, (H, obsdim))
        )
        Cuu = jnp.broadcast_to(2 * Rd * dt, (H, 1, 1))
        cu = 2 * us * Rd * dt
        Vn = jnp.zeros((ds, ds)).at[oi, oi].set(2 * Fd)
        vn = jnp.zeros(ds).at[:obsdim].set(
            2 * Fd * (xs[H, :obsdim] - a["goal"])
        )
        return tvlqr_backward_scan(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)

    return jax.vmap(one)(a["Jx"], a["Ju"], a["xs"], a["us"], a["Qd"],
                         a["Rd"], a["Fd"])


def _kernel(a, dt, obsdim):
    return pallas_tvlqr_backward_quad(
        a["Jx"], a["Ju"], a["xs"], a["us"], a["Qd"], a["Rd"], a["Fd"],
        a["goal"], dt, obsdim, interpret=True,
    )


def _assert_close(out, ref, tol=1e-10):
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                   rtol=tol, atol=tol)


# Non-power-of-two horizons and batches: Triton blocks are powers of
# two, so H is looped inside the program and the batch is padded.
@pytest.mark.parametrize("ds,H,B", [(4, 12, 8), (5, 20, 16), (2, 7, 3)])
def test_matches_scan(ds, H, B):
    a = _inputs(B, H, ds, ds)
    _assert_close(_kernel(a, 0.05, ds), _reference(a, 0.05, ds))


def test_multi_block_grid():
    """More lanes than one program holds, with a ragged last block."""
    B = 2 * BLOCK_B + 5
    a = _inputs(B, 6, 4, 4, seed=1)
    _assert_close(_kernel(a, 0.1, 4), _reference(a, 0.1, 4))


def test_rejects_multi_ctrl():
    a = _inputs(4, 5, 4, 4)
    Ju2 = jnp.concatenate([a["Ju"], a["Ju"]], axis=-1)
    with pytest.raises(ValueError, match="dc=1"):
        pallas_tvlqr_backward_quad(
            a["Jx"], Ju2, a["xs"], a["us"], a["Qd"], a["Rd"], a["Fd"],
            a["goal"], 0.05, 4, interpret=True,
        )


def test_quad_backward_matches_explicit_expansions():
    """obsdim < ds (a lifted or augmented state): the cost touches only
    the observed components, with a nonzero goal."""
    a = _inputs(6, 9, 5, 3, seed=2)
    _assert_close(_kernel(a, 0.05, 3), _reference(a, 0.05, 3))


def test_block_and_padding_helpers():
    assert block_for(1) == 1
    assert block_for(3) == 4
    assert block_for(10 ** 6) == BLOCK_B
    x = jnp.arange(10.0).reshape(5, 2)
    (padded,), B = pad_batch([x], 4)
    assert B == 5 and padded.shape == (8, 2)
    np.testing.assert_array_equal(np.asarray(padded[5:]),
                                  np.repeat(np.asarray(x[-1:]), 3, 0))
    (same,), _ = pad_batch([x], 5)
    assert same is x
