"""Horizon-sharded multiple-shooting direct transcription.

The reference's direct-transcription NLP stacks all H knot points into
one IPOPT solve on one host (autompc/control/nmpc.py:36-187: decision
variables x_0..x_H, u_0..u_{H-1}, one defect constraint per knot). The
accelerator analog of scaling that to long horizons is SEQUENCE parallelism
over the knot axis — the moral equivalent of context/ring parallelism
(SURVEY §5 "long-context"): split the horizon into P contiguous
shooting intervals, one per device on a ``horizon`` mesh axis, and run
the whole SQP under ``jax.shard_map`` with explicit boundary exchange:

* per-knot work (dynamics linearization, stage expansions, defects) is
  shard-local; the one neighbor state each chunk's first defect needs
  arrives by a single ``ppermute`` halo shift per iteration;
* the block-tridiagonal KKT factorization — the sequential Riccati
  recursion — runs block-parallel: each shard suffix-composes its own
  knots' Riccati elements (ops/riccati.py:tvlqr_element/combine — a
  local ``associative_scan``), ``all_gather``s the P per-chunk
  composite elements between devices (the cross-shard "KKT block reduction":
  5 small matrices per shard, bytes not buffers), composes the suffix
  of later chunks locally, and recovers its knots' value expansions
  and gains without ever materializing another chunk's arrays;
* the step recovery and line-search rollouts (affine recursions) use
  the same pattern: local prefix composition, all_gather of P chunk
  maps, local replay — the boundary *states* are the halo;
* merit/objective terms reduce with ``psum``.

Per-device memory is O(H / P): an H too long for one device's memory
runs by adding devices (tools/check_horizon_sharding.py measures the
per-device footprint; tests pin the sharded solve to the single-device
SQP trajectory).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.riccati import (
    highest_precision,
    tvlqr_apply_element,
    tvlqr_combine,
    tvlqr_element,
    tvlqr_gains,
    tvlqr_identity_element,
    tvlqr_suffix_scan,
)


def make_horizon_sharded_sqp_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds,
    mesh,
    axis: str = "horizon",
    sqp_iters: int = 10,
    ls_max_iter: int = 8,
    merit_mu: float = 100.0,
    reg: float = 1e-7,
    xbounds=None,
    xbound_mu: float = 100.0,
    xbound_lam_every: int = 4,
):
    """Build ``solve(params, x0, xs_guess, us_guess) -> (xs, us)`` with
    the knot axis split into shooting intervals over ``mesh[axis]``.

    Semantics match ``control.nmpc.make_sqp_solver(backward="assoc")``
    — same objective (reference nmpc.py:73-83), defects, L1-merit line
    search — the difference is the distributed execution layout
    (test-pinned against the single-device solve on the CPU mesh).
    """
    n_shards = int(mesh.shape[axis])
    if H % n_shards != 0:
        raise ValueError(
            f"horizon {H} must divide over the {n_shards}-way "
            f"'{axis}' mesh axis"
        )
    umin = jnp.asarray(ubounds[0])
    umax = jnp.asarray(ubounds[1])

    # Observation box constraints, enforced with the SAME augmented-
    # Lagrangian treatment as the single-device SQP
    # (control/nmpc.py:make_sqp_solver ``xbounds``; reference IPOPT
    # variable bounds, nmpc.py:121-130). Sharding layout: multipliers
    # for this chunk's knots align with the LOCAL xk positions (global
    # knot 0 masked on shard 0 — it is pinned to the measured state),
    # and one replicated multiplier pair covers the terminal x_H (its
    # AL term enters Vf/vf, which every shard already computes
    # identically from the all-gathered terminal state).
    has_xbounds = xbounds is not None
    if has_xbounds:
        xlo = jnp.where(
            jnp.isfinite(jnp.asarray(xbounds[0])), jnp.asarray(xbounds[0]),
            -1e9,
        )
        xhi = jnp.where(
            jnp.isfinite(jnp.asarray(xbounds[1])), jnp.asarray(xbounds[1]),
            1e9,
        )
        mu_x = xbound_mu

    fwd_perm = [(i, i + 1) for i in range(n_shards - 1)]

    def run(params, x0, xs_tail, us):
        """shard_map body. Local shapes: xs_tail (Hc, ds) holding
        x_{t+1} for this chunk's knots, us (Hc, dc); params/x0
        replicated."""
        s = jax.lax.axis_index(axis)

        def knot_states(xs_tail):
            # x_t at the chunk's knots = [incoming boundary state,
            # xs_tail[:-1]]; the incoming state is the left neighbor's
            # last x (halo), or x0 on shard 0.
            incoming = (
                jax.lax.ppermute(xs_tail[-1], axis, fwd_perm)
                if n_shards > 1
                else xs_tail[-1]
            )
            incoming = jnp.where(s == 0, x0, incoming)
            return jnp.concatenate([incoming[None], xs_tail[:-1]], axis=0)

        def x_terminal(xs_tail):
            if n_shards == 1:
                return xs_tail[-1]
            return jax.lax.all_gather(xs_tail[-1], axis)[-1]

        def clip_u(u):
            return jnp.clip(u, umin, umax)

        def objective(xk, xs_tail, us):
            # dt * sum_{i=0..H} obs(x_i) + dt * sum ctrl + term(x_H);
            # knots 0..H-1 live in xk across shards, x_H is handled
            # once (masked to the last shard to avoid double counting
            # under psum).
            oc = jnp.sum(jax.vmap(lambda x: cost.eval_obs_cost(x[:obsdim]))(xk))
            cc = jnp.sum(jax.vmap(cost.eval_ctrl_cost)(us))
            xH = x_terminal(xs_tail)
            oc_total = jax.lax.psum(oc, axis)
            cc_total = jax.lax.psum(cc, axis)
            return (
                dt * (oc_total + cc_total + cost.eval_obs_cost(xH[:obsdim]))
                + cost.eval_term_obs_cost(xH[:obsdim])
            )

        def defects(xk, xs_tail, us):
            preds = jax.vmap(lambda x, u: pred_core(params, x, u))(xk, us)
            return preds - xs_tail

        if has_xbounds:
            Hc = xs_tail.shape[0]
            # Local knot weights: global knot 0 (shard 0's first local
            # knot) is pinned, so its multipliers stay zero.
            knot_w = jnp.ones(Hc).at[0].set(
                jnp.where(s == 0, 0.0, 1.0)
            )

            def al_terms(xo, lam_lo_i, lam_hi_i, w):
                t_hi = jnp.maximum(0.0, lam_hi_i + mu_x * (xo - xhi)) * w
                t_lo = jnp.maximum(0.0, lam_lo_i + mu_x * (xlo - xo)) * w
                pen = (
                    jnp.sum(t_hi**2 - (lam_hi_i * w) ** 2)
                    + jnp.sum(t_lo**2 - (lam_lo_i * w) ** 2)
                ) / (2.0 * mu_x)
                grad = t_hi - t_lo
                hdiag = mu_x * (
                    (t_hi > 0).astype(xo.dtype)
                    + (t_lo > 0).astype(xo.dtype)
                )
                return pen, grad, hdiag

            def al_local(xk, lam):
                lam_lo, lam_hi = lam
                return jax.vmap(al_terms)(
                    xk[:, :obsdim], lam_lo, lam_hi, knot_w
                )

        def merit(xk, xs_tail, us, lam=None, lam_T=None):
            d = defects(xk, xs_tail, us)
            m = objective(xk, xs_tail, us) + merit_mu * jax.lax.psum(
                jnp.sum(jnp.abs(d)), axis
            )
            if has_xbounds:
                pens, _, _ = al_local(xk, lam)
                pen_T, _, _ = al_terms(
                    x_terminal(xs_tail)[:obsdim], lam_T[0], lam_T[1],
                    jnp.ones(()),
                )
                # Local penalties reduce over shards; the terminal
                # penalty is computed identically on every shard (from
                # the all-gathered x_H), so it adds OUTSIDE the psum.
                m = m + jax.lax.psum(jnp.sum(pens), axis) + pen_T
            return m

        def suffix_of_later_chunks(chunk_elem):
            """Compose the per-chunk elements of every shard AFTER this
            one (the cross-shard block reduction): all_gather the P
            composite elements, mask earlier/self chunks to the
            identity, and fold left-to-right (earlier first)."""
            ident = tvlqr_identity_element(ds, xs_tail.dtype)
            if n_shards == 1:
                return ident
            gathered = jax.tree_util.tree_map(
                lambda x: jax.lax.all_gather(x, axis), chunk_elem
            )
            R = ident
            for i in range(n_shards):
                e_i = jax.tree_util.tree_map(lambda g: g[i], gathered)
                e_i = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(i > s, a, b), e_i, ident
                )
                R = tvlqr_combine(R, e_i)
            return R

        def backward(Jx, Ju, Cxx, Cuu, cx, cu, d_seq, Vf, vf):
            elems = jax.vmap(lambda *a: tvlqr_element(*a, reg=reg))(
                Jx, Ju, Cxx, Cuu, cx, cu, d_seq
            )
            local_suffix = tvlqr_suffix_scan(elems)     # S_t within chunk
            chunk_elem = jax.tree_util.tree_map(
                lambda x: x[0], local_suffix
            )
            R_later = suffix_of_later_chunks(chunk_elem)
            # Full suffix at each local knot: S_t (earlier) ∘ R_later.
            full = jax.vmap(
                lambda *e: tvlqr_combine(e, R_later)
            )(*local_suffix)
            V_all, v_all = jax.vmap(
                lambda *e: tvlqr_apply_element(e, Vf, vf)
            )(*full)
            # Next-step value: within the chunk it's the t+1 entry; the
            # last local knot's comes from the NEXT chunk's boundary =
            # R_later applied to the terminal expansion.
            Vb, vb = tvlqr_apply_element(R_later, Vf, vf)
            V_next = jnp.concatenate([V_all[1:], Vb[None]], axis=0)
            v_next = jnp.concatenate([v_all[1:], vb[None]], axis=0)
            Ks, ks, lin_t, quad_t = jax.vmap(
                lambda *a: tvlqr_gains(*a, reg=reg)
            )(Jx, Ju, Cuu, cu, d_seq, V_next, v_next)
            return Ks, ks

        def affine_chunk_rollout(Acl, bcl):
            """dx at this chunk's xs_tail positions, via local prefix
            composition + all_gather of the P chunk maps + local
            replay from the incoming boundary dx (dx_0 = 0)."""
            def combine(f, g):
                A1, b1 = f
                A2, b2 = g
                return A2 @ A1, A2 @ b1 + b2

            As, bs = jax.lax.associative_scan(
                jax.vmap(combine), (Acl, bcl)
            )
            if n_shards == 1:
                dx_in = jnp.zeros(ds, dtype=Acl.dtype)
            else:
                gA = jax.lax.all_gather(As[-1], axis)     # (P, ds, ds)
                gb = jax.lax.all_gather(bs[-1], axis)     # (P, ds)
                dx_in = jnp.zeros(ds, dtype=Acl.dtype)
                for i in range(n_shards):
                    nxt = gA[i] @ dx_in + gb[i]
                    dx_in = jnp.where(i < s, nxt, dx_in)
            dxs1 = jnp.einsum("tij,j->ti", As, dx_in) + bs  # (Hc, ds)
            dx_knots = jnp.concatenate([dx_in[None], dxs1[:-1]], axis=0)
            return dx_knots, dxs1

        def stage_expansions(xk, us):
            def one(x, u):
                _, qx, Qh = cost.eval_obs_cost_hess(x[:obsdim])
                _, ru, Rh = cost.eval_ctrl_cost_hess(u)
                Cxx = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(Qh * dt)
                cx = jnp.zeros(ds).at[:obsdim].set(qx * dt)
                return Cxx, Rh * dt, cx, ru * dt

            return jax.vmap(one)(xk, us)

        alphas = 0.5 ** jnp.arange(ls_max_iter)

        def sqp_iteration(carry, it):
            if has_xbounds:
                xs_tail, us, lam, lam_T = carry
            else:
                xs_tail, us = carry
                lam = lam_T = None
            xk = knot_states(xs_tail)

            def lin_one(x, u):
                jx = jax.jacfwd(lambda q: pred_core(params, q, u))(x)
                ju = jax.jacfwd(lambda q: pred_core(params, x, q))(u)
                return jx, ju

            A_seq, B_seq = jax.vmap(lin_one)(xk, us)
            d_seq = defects(xk, xs_tail, us)
            Cxx, Cuu, cx, cu = stage_expansions(xk, us)
            xH = x_terminal(xs_tail)
            _, tg, th = cost.eval_term_obs_cost_hess(xH[:obsdim])
            _, sg, sh = cost.eval_obs_cost_hess(xH[:obsdim])
            Vf = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(th + sh * dt)
            vf = jnp.zeros(ds).at[:obsdim].set(tg + sg * dt)

            if has_xbounds:
                _, g_loc, h_loc = al_local(xk, lam)
                oi = jnp.arange(obsdim)
                Cxx = Cxx.at[:, oi, oi].add(h_loc)
                cx = cx.at[:, :obsdim].add(g_loc)
                _, g_T, h_T = al_terms(
                    xH[:obsdim], lam_T[0], lam_T[1], jnp.ones(())
                )
                Vf = Vf.at[oi, oi].add(h_T)
                vf = vf.at[:obsdim].add(g_T)

            Ks, ks = backward(A_seq, B_seq, Cxx, Cuu, cx, cu, d_seq, Vf, vf)

            merit0 = merit(xk, xs_tail, us, lam, lam_T)

            Acl = A_seq + jnp.einsum("tij,tjk->tik", B_seq, Ks)

            def try_alpha(alpha):
                bcl = alpha * (
                    jnp.einsum("tij,tj->ti", B_seq, ks) + d_seq
                )
                dx_knots, dxs1 = affine_chunk_rollout(Acl, bcl)
                dus = alpha * ks + jnp.einsum("tij,tj->ti", Ks, dx_knots)
                xs_new = xs_tail + dxs1
                us_new = clip_u(us + dus)
                return (
                    xs_new, us_new,
                    merit(knot_states(xs_new), xs_new, us_new, lam, lam_T),
                )

            xs_c, us_c, merits = jax.vmap(try_alpha)(alphas)
            improved = merits < merit0
            idx = jnp.argmax(improved)
            any_imp = jnp.any(improved)
            xs_next = jnp.where(any_imp, xs_c[idx], xs_tail)
            us_next = jnp.where(any_imp, us_c[idx], us)
            if has_xbounds:
                # Delayed first-order dual update (control/nmpc.py:
                # per-step updates make primal and dual chase each
                # other; see that docstring).
                do_update = (
                    it % xbound_lam_every
                ) == (xbound_lam_every - 1)
                xk_new = knot_states(xs_next)[:, :obsdim]
                lam_lo, lam_hi = lam
                lam_hi_n = jnp.maximum(
                    0.0, lam_hi + mu_x * (xk_new - xhi)
                ) * knot_w[:, None]
                lam_lo_n = jnp.maximum(
                    0.0, lam_lo + mu_x * (xlo - xk_new)
                ) * knot_w[:, None]
                xH_new = x_terminal(xs_next)[:obsdim]
                lam_T_lo_n = jnp.maximum(
                    0.0, lam_T[0] + mu_x * (xlo - xH_new)
                )
                lam_T_hi_n = jnp.maximum(
                    0.0, lam_T[1] + mu_x * (xH_new - xhi)
                )
                lam = (
                    jnp.where(do_update, lam_lo_n, lam_lo),
                    jnp.where(do_update, lam_hi_n, lam_hi),
                )
                lam_T = (
                    jnp.where(do_update, lam_T_lo_n, lam_T[0]),
                    jnp.where(do_update, lam_T_hi_n, lam_T[1]),
                )
                return (xs_next, us_next, lam, lam_T), merits[idx]
            return (xs_next, us_next), merits[idx]

        if has_xbounds:
            Hc0 = xs_tail.shape[0]
            lam0 = (
                jnp.zeros((Hc0, obsdim)), jnp.zeros((Hc0, obsdim))
            )
            lam_T0 = (jnp.zeros(obsdim), jnp.zeros(obsdim))
            carry0 = (xs_tail, us, lam0, lam_T0)
        else:
            carry0 = (xs_tail, us)
        out, _ = jax.lax.scan(
            sqp_iteration, carry0, jnp.arange(sqp_iters)
        )
        return out[0], out[1]

    sharded = jax.jit(
        jax.shard_map(
            highest_precision(run),
            mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
    )

    @jax.jit
    def solve(params, x0, xs_guess, us_guess):
        xs_tail, us = sharded(params, x0, xs_guess[1:], us_guess)
        return jnp.concatenate([x0[None], xs_tail], axis=0), us

    return solve
