"""Iterative LQR as one fused XLA program.

Re-creates the reference iLQR controller (reference:
autompc/control/ilqr.py:43-295) with exact algorithmic semantics —
dt-scaled stage expansions, Riccati backward pass, ``alpha = 0.2^i``
backtracking line search with the 0.3 expected-reduction acceptance test,
``||k||``/``||du||`` thresholds — but compiled as a single jitted solve:

* forward rollout + Jacobians: one ``lax.scan`` with ``jax.jacfwd``
  (replaces the per-step Python loop + hand-written ``pred_diff``,
  ilqr.py:144-147)
* backward pass: ``lax.scan`` in reverse (ops/riccati.py:
  tvlqr_backward_scan; replaces ilqr.py:165-187)
* line search: all alphas rolled out together via ``vmap`` over a scan
  (the reference already batches alphas per-timestep, ilqr.py:196-205;
  here the whole rollout is one fused kernel)
* outer iteration: ``lax.while_loop`` with masked accept/fail logic
  (replaces the Python loop + breaks, ilqr.py:160-248)

The solver is a pure function of (model params, x0, uguess), so the tuner
reuses one compiled program across every candidate model of the same
shape.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..ops.riccati import highest_precision, tvlqr_backward_scan
from .controller import Controller, ControllerFactory


def make_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    u_threshold: float = 1e-3,
    max_iter: int = 50,
    ls_max_iter: int = 10,
    ls_discount: float = 0.2,
    ls_cost_threshold: float = 0.3,
    unroll: int = 8,
    backward: str = "scan",
    pred_diff=None,
):
    """Build a jittable iLQR solve:
    ``solve(params, x0, uguess) -> (converged, xs, us, Ks, ks)``.

    ``backward``: "scan" (sequential ``lax.scan``) or "assoc"
    (O(log H)-depth associative-scan Riccati for long horizons;
    ops/riccati.py:tvlqr_backward_assoc).

    ``pred_diff``: optional ``(params, x, u) -> (pred, Jx, Ju)`` with a
    closed-form model Jacobian (e.g. ``MLP.pred_diff_core``) replacing
    the default ``jax.jacfwd`` formulation — see
    ``make_batched_ilqr_solver``.

    Semantics mirror ``IterativeLQR.compute_ilqr_default``
    (ilqr.py:100-265), including its quirks: Jacobians are only
    re-linearized after a *successful* line search, and a step that
    fails the sufficient-decrease test but worsens the objective by at
    most 1e-3 is still accepted (ilqr.py:226-233).
    """
    if ubounds is not None:
        umin = jnp.asarray(ubounds[0])
        umax = jnp.asarray(ubounds[1])

    def clip_u(u):
        return jnp.clip(u, umin, umax) if ubounds is not None else u

    if pred_diff is None:
        def pred_diff(params, x, u):
            pred = pred_core(params, x, u)
            jx = jax.jacfwd(lambda s: pred_core(params, s, u))(x)
            ju = jax.jacfwd(lambda uu: pred_core(params, x, uu))(u)
            return pred, jx, ju

    def forward(params, x0, us):
        def step(x, u):
            pred, jx, ju = pred_diff(params, x, u)
            return pred, (pred, jx, ju)

        _, (xs1, Jx, Ju) = jax.lax.scan(step, x0, us, unroll=unroll)
        return jnp.concatenate([x0[None], xs1], axis=0), Jx, Ju

    def relinearize(params, xs, us):
        def one(x, u):
            _, jx, ju = pred_diff(params, x, u)
            return jx, ju

        return jax.vmap(one)(xs[:H], us)

    def eval_obj(xs, us):
        # dt * sum_{t<H}(obs cost + ctrl cost) + terminal (ilqr.py:126-131)
        oc = jnp.sum(jax.vmap(lambda x: cost.eval_obs_cost(x[:obsdim]))(xs[:H]))
        cc = jnp.sum(jax.vmap(cost.eval_ctrl_cost)(us))
        return dt * (oc + cc) + cost.eval_term_obs_cost(xs[H, :obsdim])

    def stage_expansions(xs, us):
        def one(x, u):
            _, qx, Qh = cost.eval_obs_cost_hess(x[:obsdim])
            _, ru, Rh = cost.eval_ctrl_cost_hess(u)
            Cxx = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(Qh * dt)
            cx = jnp.zeros(ds).at[:obsdim].set(qx * dt)
            return Cxx, Rh * dt, cx, ru * dt

        return jax.vmap(one)(xs[:H], us)

    alphas = ls_discount ** jnp.arange(ls_max_iter)

    def line_search(params, x0, xs, us, Ks, ks):
        def rollout(alpha):
            def step(x, inp):
                xbar, ubar, K, k = inp
                u = clip_u(alpha * k + ubar + K @ (x - xbar))
                x1 = pred_core(params, x, u)
                return x1, (x1, u)

            _, (xs1, us1) = jax.lax.scan(
                step, x0, (xs[:H], us, Ks, ks), unroll=unroll
            )
            return jnp.concatenate([x0[None], xs1], axis=0), us1

        return jax.vmap(rollout)(alphas)

    @highest_precision
    def solve(params, x0, uguess):
        xs0, Jx0, Ju0 = forward(params, x0, uguess)
        obj0 = eval_obj(xs0, uguess)
        carry0 = dict(
            xs=xs0,
            us=uguess,
            Jx=Jx0,
            Ju=Ju0,
            obj=obj0,
            Ks=jnp.zeros((H, dc, ds)),
            ks=jnp.zeros((H, dc)),
            itr=jnp.array(0),
            converged=jnp.array(False),
            failed=jnp.array(False),
        )

        def cond(c):
            return (c["itr"] < max_iter) & ~c["converged"] & ~c["failed"]

        def body(c):
            xs, us = c["xs"], c["us"]
            # Terminal value expansion (ilqr.py:159-164).
            _, tg, th = cost.eval_term_obs_cost_hess(xs[H, :obsdim])
            Vn = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(th)
            vn = jnp.zeros(ds).at[:obsdim].set(tg)
            Cxx, Cuu, cx, cu = stage_expansions(xs, us)
            if backward == "assoc":
                from ..ops.riccati import tvlqr_backward_assoc

                Ks, ks, lin_red, quad_red = tvlqr_backward_assoc(
                    c["Jx"], c["Ju"], Cxx, Cuu, cx, cu, Vn, vn
                )
            else:
                Ks, ks, lin_red, quad_red = tvlqr_backward_scan(
                    c["Jx"], c["Ju"], Cxx, Cuu, cx, cu, Vn, vn, unroll=unroll
                )
            ks_norm = jnp.linalg.norm(ks)

            ls_xs, ls_us = line_search(params, x0, xs, us, Ks, ks)
            new_objs = jax.vmap(eval_obj)(ls_xs, ls_us)
            expect = alphas * lin_red + alphas**2 * quad_red / 2
            denom = -expect
            ratios = jnp.where(
                jnp.abs(denom) > 1e-30, (c["obj"] - new_objs) / denom, -jnp.inf
            )
            accept = ratios > ls_cost_threshold
            ks_small = ks_norm < u_threshold
            any_acc = jnp.any(accept)
            first_acc = jnp.argmax(accept)
            # First acceptor wins; otherwise argmin over objectives; with
            # a tiny k only alpha 0 is ever evaluated (ilqr.py:208-225).
            chosen = jnp.where(
                ks_small, 0, jnp.where(any_acc, first_acc, jnp.argmin(new_objs))
            )
            best_obj = new_objs[chosen]
            ls_success = (best_obj < c["obj"]) | ks_small
            # Objective of the last alpha the reference would have
            # evaluated before leaving its loop (ilqr.py:226-227).
            idx_last = jnp.where(
                ks_small, 0, jnp.where(any_acc, first_acc, ls_max_iter - 1)
            )
            last_obj = new_objs[idx_last]
            failed = (~ls_success) & (last_obj > c["obj"] + 1e-3)

            sel = jnp.where(ls_success, chosen, idx_last)
            new_xs = ls_xs[sel]
            new_us = ls_us[sel]
            new_obj = jnp.where(ls_success, best_obj, last_obj)

            Jx_new, Ju_new = jax.lax.cond(
                ls_success,
                lambda: relinearize(params, new_xs, new_us),
                lambda: (c["Jx"], c["Ju"]),
            )
            du_norm = jnp.linalg.norm(new_us - us)
            converged = (du_norm < u_threshold) & ~failed

            keep = lambda new, old: jnp.where(failed, old, new)
            return dict(
                xs=keep(new_xs, xs),
                us=keep(new_us, us),
                Jx=keep(Jx_new, c["Jx"]),
                Ju=keep(Ju_new, c["Ju"]),
                obj=keep(new_obj, c["obj"]),
                Ks=Ks,
                ks=ks,
                itr=c["itr"] + 1,
                converged=converged,
                failed=failed,
            )

        out = jax.lax.while_loop(cond, body, carry0)
        return out["converged"], out["xs"], out["us"], out["Ks"], out["ks"]

    return solve


def kernels_available(pallas_interpret: bool = False) -> bool:
    """Whether the solver's hand-written kernels run here: compiled on
    the GPU, or in interpret mode when the caller asks for it (CPU
    tests). Other platforms take the plain XLA paths."""
    return bool(pallas_interpret) or jax.default_backend() == "gpu"


def make_batched_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    u_threshold: float = 1e-3,
    max_iter: int = 50,
    ls_max_iter: int = 10,
    ls_discount: float = 0.2,
    ls_cost_threshold: float = 0.3,
    unroll: int = 8,
    backward: str = "auto",
    feature_spec=None,
    analytic_jac: bool = False,
    feature_mask=None,
    return_pieces: bool = False,
    quad_cost_batch: bool = False,
    quad_goal=None,
    batch_params: bool = False,
    reg_matrix=None,
    reg_goal=None,
    pred_diff=None,
    horizon_mask: bool = False,
    pallas_interpret: bool = False,
):
    """Batch-native iLQR solve: ``solve(params, x0s (B,ds), uguess
    (B,H,dc)) -> (converged (B,), xs, us, Ks, ks)``.

    Functionally equivalent to ``jax.vmap(make_ilqr_solver(...))`` (the
    outer iteration is a single ``while_loop`` with per-lane activity
    masks, which is vmap's batching rule for while_loop), but every
    phase sees the whole batch at once.

    **Path choice.** The platform and the inputs pick the path; there
    are no kernel knobs. Where ``kernels_available()`` holds (on the
    GPU, or with ``pallas_interpret=True`` in tests):

    * the backward pass runs the Pallas kernel with inline diagonal-
      quadratic expansions (ops/pallas_riccati.py) when dc == 1, the
      cost is a diagonal quadratic (a fixed diagonal ``QuadCost`` or
      ``quad_cost_batch`` without ``reg_matrix``) and ``horizon_mask``
      is off, and ``backward`` is "auto";
    * the line search runs the fused Pallas kernel
      (ops/pallas_linesearch.py: rollout of every alpha, objective,
      acceptance rule, and the Jacobians of the accepted trajectory)
      when ``feature_spec`` is given and the cost is quadratic.

    A kernel that fails to compile raises; nothing falls back. Elsewhere
    the backward pass is ``vmap(tvlqr_backward_scan)`` (or the
    O(log H)-depth ``tvlqr_backward_assoc`` with ``backward="assoc"``),
    and the line search rolls every alpha with ``vmap(lax.scan)``.
    ``backward="scan"`` names the XLA recursion explicitly (the plain
    reference, and the A/B against the kernel). All XLA dots run at
    ``"highest"`` matmul precision.

    ``batch_params=True`` gives every lane its OWN model: every leaf of
    ``params`` carries a leading batch axis (e.g. SINDy coefficients
    ``(B, ds, F)``). This is what lets the joint tuning fan-out (a
    fresh sysid model trained per candidate; reference
    autompc/tuning/pipeline_tuner.py:213-258) evaluate a whole
    candidate batch in one solver program. Converged-lane compaction
    gathers the params rows alongside the rest of the carry.

    ``return_pieces=True`` additionally returns the solver's building
    blocks ``(solve, make_carry0, cond, make_body)`` (the outer
    while_loop's init/cond/body) so callers can drive the iteration
    themselves (the compacting solvers below).

    ``quad_cost_batch=True`` gives every lane its OWN diagonal
    quadratic cost: the solve takes a fourth argument ``cost_params``,
    a dict of per-lane diagonals ``Qdiag (B, obsdim)``, ``Rdiag
    (B, dc)``, ``Fdiag (B, obsdim)`` (the QuadCostFactory search
    space, costs/quad_cost_factory.py) with the shared ``quad_goal``;
    ``cost`` is ignored and may be None (value ``(x-g)'Q(x-g)``,
    gradient ``2Q(x-g)``, hessian ``2Q``, costs/cost.py:62-141).

    ``reg_matrix`` / ``reg_goal`` (requires ``quad_cost_batch``) add a
    per-lane-weighted shared dense quadratic stage term
    ``regw * (x - reg_goal)' reg_matrix (x - reg_goal)``: the
    GaussRegFactory candidate space (``Q = w Sigma_x^{-1}``, goal
    ``mu_x``; costs/gauss_reg_factory.py). ``cost_params`` then also
    carries ``regw (B,)``; ``reg_matrix`` must be symmetric.

    ``pred_diff``: optional ``(params, x, u) -> (pred, Jx, Ju)`` with a
    closed-form model Jacobian (e.g. ``MLP.pred_diff_core``) replacing
    ``jax.jacfwd`` in the forward/relinearization phases.

    ``feature_spec``: optional ``(feature_library, coeffs_param_key)``
    declaring the model linear in features (discrete-time SINDy/Koopman
    form ``x' = coeffs @ theta(x, u)``). ``analytic_jac=True`` uses the
    library's closed-form feature Jacobians in the XLA forward and
    relinearization passes.

    ``feature_mask``: optional static feature sparsity for the line-
    search kernel: a boolean sequence over the library's features, or
    a tuple of active feature indices. A thresholded STLSQ fit leaves
    most coefficient columns exactly zero (the headline cartpole model
    uses 7 of 55 features); masking drops dead features at trace time.
    The compiled solve is only correct for params whose coefficients
    are zero outside the mask, so pass it only when the model is fixed.

    ``horizon_mask``: horizon-polymorphic solves. The program compiles
    once at H = H_max; every lane carries its own effective horizon
    ``cost_params["heff"]`` (B,) int32 and steps t >= heff are inert:
    frozen dynamics (x_{t+1} = x_t, Jx = I, Ju = 0), zero stage cost,
    controls pinned to their previous value. The padded solve is
    algebraically identical to a dedicated solve at H = heff
    (tests/test_horizon_mask.py). It lets the AutoML tuner compile one
    program for every controller horizon instead of one per horizon
    (reference horizon space: autompc/control/ilqr.py:24-27).
    """
    from ..ops.riccati import tvlqr_backward_assoc

    if backward not in ("auto", "scan", "assoc"):
        raise ValueError(
            f"backward must be 'auto', 'scan' or 'assoc', got {backward!r}"
        )
    if ubounds is not None:
        umin = jnp.asarray(ubounds[0])
        umax = jnp.asarray(ubounds[1])

    def clip_u(u):
        return jnp.clip(u, umin, umax) if ubounds is not None else u

    p_ax = 0 if batch_params else None

    if feature_mask is not None:
        if feature_spec is None:
            raise ValueError("feature_mask needs feature_spec")
        fm = tuple(feature_mask)
        if all(isinstance(b, (bool, np.bool_)) for b in fm):
            active_idx = tuple(i for i, b in enumerate(fm) if b)
        else:
            active_idx = tuple(int(i) for i in fm)
        if not active_idx:
            raise ValueError("feature_mask masks out every feature")
    else:
        active_idx = None

    def _active_terms(library):
        """Static term-fns / grad-terms filtered to the active feature
        set, plus a coeffs-column selector applied inside the trace."""
        fns = tuple(library._fns)
        gts = getattr(library, "grad_terms", None)
        if active_idx is None:
            return fns, gts, (lambda c: c)
        fns_a = tuple(fns[k] for k in active_idx)
        gts_a = (
            tuple(gts[k] for k in active_idx) if gts is not None else None
        )
        sel = jnp.asarray(active_idx, dtype=jnp.int32)
        # ``...`` handles both shared (ds, F) and per-lane (B, ds, F)
        # coefficient planes.
        return fns_a, gts_a, (lambda c: c[..., sel])

    if reg_matrix is not None and not quad_cost_batch:
        raise ValueError("reg_matrix requires quad_cost_batch=True")
    if horizon_mask:
        if not quad_cost_batch:
            raise ValueError("horizon_mask requires quad_cost_batch=True")
        if feature_spec is not None or analytic_jac:
            raise ValueError(
                "horizon_mask does not compose with feature-library "
                "solvers yet; keep horizon in the bucket key for "
                "feature-spec solvers"
            )

    # Diagonal quadratic costs: the expansions are a handful of per-lane
    # multiplies, which the backward kernel computes inline from
    # (xs, us).
    fixed_diag = None
    if not quad_cost_batch and getattr(cost, "is_quad", False) and hasattr(
        cost, "_Q"
    ):
        Qm, Rm, Fm = (np.asarray(cost._Q), np.asarray(cost._R),
                      np.asarray(cost._F))
        if all(np.allclose(M, np.diag(np.diag(M))) for M in (Qm, Rm, Fm)):
            g = getattr(cost, "_goal", None)
            fixed_diag = (
                jnp.asarray(np.diag(Qm)), jnp.asarray(np.diag(Rm)),
                jnp.asarray(np.diag(Fm)),
                jnp.asarray(np.zeros(obsdim) if g is None else np.asarray(g)),
            )
    kernels = kernels_available(pallas_interpret)
    diag_cost = (quad_cost_batch and reg_matrix is None) or (
        fixed_diag is not None
    )
    use_bq_kernel = (
        kernels and backward == "auto" and dc == 1 and diag_cost
        and not horizon_mask
    )
    quad_cost = quad_cost_batch or (
        getattr(cost, "is_quad", False) and hasattr(cost, "_Q")
    )
    use_ls_kernel = kernels and feature_spec is not None and quad_cost

    def relinearize_one(params, xs, us):
        if analytic_jac and feature_spec is not None:
            # Linear-in-features: Jacobian = coeffs @ dTheta/dz with the
            # library's analytic feature Jacobian (one feature-eval of
            # work instead of jacfwd's d pushforwards).
            library, coeffs_key = feature_spec
            z = jnp.concatenate([xs[:H], us], axis=-1)
            Jth = library.jacobian(z)                      # (H, F, ds+dc)
            jac = jnp.einsum("hfd,sf->hsd", Jth, params[coeffs_key])
            return jac[..., :ds], jac[..., ds:]

        if pred_diff is not None:
            def one_pd(x, u):
                _, jx, ju = pred_diff(params, x, u)
                return jx, ju

            return jax.vmap(one_pd)(xs[:H], us)

        def one(x, u):
            jx = jax.jacfwd(lambda s: pred_core(params, s, u))(x)
            ju = jax.jacfwd(lambda uu: pred_core(params, x, uu))(u)
            return jx, ju

        return jax.vmap(one)(xs[:H], us)

    def forward_one(params, x0, us):
        if analytic_jac and feature_spec is not None:
            def step(x, u):
                pred = pred_core(params, x, u)
                return pred, pred

            _, xs1 = jax.lax.scan(step, x0, us, unroll=unroll)
            xs = jnp.concatenate([x0[None], xs1], axis=0)
            Jx, Ju = relinearize_one(params, xs, us)
            return xs, Jx, Ju

        if pred_diff is not None:
            def step_pd(x, u):
                pred, jx, ju = pred_diff(params, x, u)
                return pred, (pred, jx, ju)

            _, (xs1, Jx, Ju) = jax.lax.scan(step_pd, x0, us, unroll=unroll)
            return jnp.concatenate([x0[None], xs1], axis=0), Jx, Ju

        def step(x, u):
            pred = pred_core(params, x, u)
            jx = jax.jacfwd(lambda s: pred_core(params, s, u))(x)
            ju = jax.jacfwd(lambda uu: pred_core(params, x, uu))(u)
            return pred, (pred, jx, ju)

        _, (xs1, Jx, Ju) = jax.lax.scan(step, x0, us, unroll=unroll)
        return jnp.concatenate([x0[None], xs1], axis=0), Jx, Ju

    _tsteps = jnp.arange(H)

    def forward_one_m(params, x0, us, heff):
        """horizon_mask initial rollout: steps t >= heff freeze the
        state and linearize as (I, 0) — see the horizon_mask doc."""
        m = _tsteps < heff

        def step(x, inp):
            u, mt = inp
            if pred_diff is not None:
                pred, jx, ju = pred_diff(params, x, u)
            else:
                pred = pred_core(params, x, u)
                jx = jax.jacfwd(lambda s: pred_core(params, s, u))(x)
                ju = jax.jacfwd(lambda uu: pred_core(params, x, uu))(u)
            pred = jnp.where(mt, pred, x)
            jx = jnp.where(mt, jx, jnp.eye(ds, dtype=jx.dtype))
            ju = jnp.where(mt, ju, jnp.zeros_like(ju))
            return pred, (pred, jx, ju)

        _, (xs1, Jx, Ju) = jax.lax.scan(
            step, x0, (us, m), unroll=unroll
        )
        return jnp.concatenate([x0[None], xs1], axis=0), Jx, Ju

    if quad_cost_batch:
        goal = (
            jnp.zeros(obsdim) if quad_goal is None
            else jnp.asarray(quad_goal)
        )
        if reg_matrix is not None:
            Sreg = jnp.asarray(reg_matrix)
            mureg = (
                jnp.zeros(obsdim) if reg_goal is None
                else jnp.asarray(reg_goal)
            )

        def _stage_mask(cp, dtype):
            # (H,) 1/0 stage-cost mask from the lane's effective
            # horizon (horizon_mask only; 1s otherwise — traced away).
            if horizon_mask:
                return (_tsteps < cp["heff"]).astype(dtype)
            return None

        def eval_obj_one(xs, us, cp):
            dx = xs[:H, :obsdim] - goal
            sw = _stage_mask(cp, xs.dtype)
            qterm = dx * dx * cp["Qdiag"][None, :]
            rterm = us * us * cp["Rdiag"][None, :]
            if sw is not None:
                qterm = qterm * sw[:, None]
                rterm = rterm * sw[:, None]
            oc = jnp.sum(qterm)
            cc = jnp.sum(rterm)
            if reg_matrix is not None:
                dxm = xs[:H, :obsdim] - mureg
                gterm = dxm * (dxm @ Sreg)
                if sw is not None:
                    gterm = gterm * sw[:, None]
                oc = oc + cp["regw"] * jnp.sum(gterm)
            dxt = xs[H, :obsdim] - goal
            return dt * (oc + cc) + jnp.sum(dxt * dxt * cp["Fdiag"])

        def expansions_one(xs, us, cp):
            dx = xs[:H, :obsdim] - goal                     # (H, n)
            sw = _stage_mask(cp, xs.dtype)
            cx = jnp.zeros((H, ds)).at[:, :obsdim].set(
                2.0 * dx * cp["Qdiag"][None, :] * dt
            )
            oi = jnp.arange(obsdim)
            Cxx = jnp.zeros((H, ds, ds)).at[:, oi, oi].set(
                jnp.broadcast_to(2.0 * cp["Qdiag"] * dt, (H, obsdim))
            )
            if reg_matrix is not None:
                dxm = xs[:H, :obsdim] - mureg
                cx = cx.at[:, :obsdim].add(
                    2.0 * dt * cp["regw"] * (dxm @ Sreg)
                )
                Cxx = Cxx.at[:, :obsdim, :obsdim].add(
                    2.0 * dt * cp["regw"] * Sreg[None]
                )
            ci = jnp.arange(dc)
            Cuu = jnp.zeros((H, dc, dc)).at[:, ci, ci].set(
                jnp.broadcast_to(2.0 * cp["Rdiag"] * dt, (H, dc))
            )
            cu = 2.0 * us * cp["Rdiag"][None, :] * dt
            if sw is not None:
                # Inert padded steps: zero state cost and cost
                # gradients; Cuu stays PD (with Ju = 0 and cu = 0 the
                # Riccati step still returns K = k = 0 there).
                cx = cx * sw[:, None]
                Cxx = Cxx * sw[:, None, None]
                cu = cu * sw[:, None]
            return Cxx, Cuu, cx, cu

        def term_one(x, cp):
            dxt = x[:obsdim] - goal
            Vn = jnp.zeros((ds, ds)).at[
                jnp.arange(obsdim), jnp.arange(obsdim)
            ].set(2.0 * cp["Fdiag"])
            vn = jnp.zeros(ds).at[:obsdim].set(2.0 * cp["Fdiag"] * dxt)
            return Vn, vn

    else:

        def eval_obj_one(xs, us, cp=None):
            oc = jnp.sum(
                jax.vmap(lambda x: cost.eval_obs_cost(x[:obsdim]))(xs[:H])
            )
            cc = jnp.sum(jax.vmap(cost.eval_ctrl_cost)(us))
            return dt * (oc + cc) + cost.eval_term_obs_cost(xs[H, :obsdim])

        def expansions_one(xs, us, cp=None):
            def one(x, u):
                _, qx, Qh = cost.eval_obs_cost_hess(x[:obsdim])
                _, ru, Rh = cost.eval_ctrl_cost_hess(u)
                Cxx = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(Qh * dt)
                cx = jnp.zeros(ds).at[:obsdim].set(qx * dt)
                return Cxx, Rh * dt, cx, ru * dt

            return jax.vmap(one)(xs[:H], us)

        def term_one(x, cp=None):
            _, tg, th = cost.eval_term_obs_cost_hess(x[:obsdim])
            Vn = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(th)
            vn = jnp.zeros(ds).at[:obsdim].set(tg)
            return Vn, vn

    alphas_static = tuple(float(ls_discount) ** i for i in range(ls_max_iter))
    alphas = jnp.asarray(alphas_static)

    def line_search_one(params, x0, xs, us, Ks, ks):
        def rollout(alpha):
            def step(x, inp):
                xbar, ubar, K, k = inp
                u = clip_u(alpha * k + ubar + K @ (x - xbar))
                x1 = pred_core(params, x, u)
                return x1, (x1, u)

            _, (xs1, us1) = jax.lax.scan(
                step, x0, (xs[:H], us, Ks, ks), unroll=unroll
            )
            return jnp.concatenate([x0[None], xs1], axis=0), us1

        return jax.vmap(rollout)(alphas)

    def line_search_one_m(params, x0, xs, us, Ks, ks, heff):
        """horizon_mask line search: padded steps keep their previous
        control (du = 0 there) and freeze the state."""
        m = _tsteps < heff

        def rollout(alpha):
            def step(x, inp):
                xbar, ubar, K, k, mt = inp
                u = clip_u(alpha * k + ubar + K @ (x - xbar))
                u = jnp.where(mt, u, ubar)
                x1 = jnp.where(mt, pred_core(params, x, u), x)
                return x1, (x1, u)

            _, (xs1, us1) = jax.lax.scan(
                step, x0, (xs[:H], us, Ks, ks, m), unroll=unroll
            )
            return jnp.concatenate([x0[None], xs1], axis=0), us1

        return jax.vmap(rollout)(alphas)

    def diag_cost_rows(cp, B):
        """Per-lane cost diagonals and the shared goal, for the kernels."""
        if quad_cost_batch:
            return cp["Qdiag"], cp["Rdiag"], cp["Fdiag"], goal
        qdf, rdf, fdf, goal_f = fixed_diag
        return (
            jnp.broadcast_to(qdf, (B, obsdim)),
            jnp.broadcast_to(rdf, (B, dc)),
            jnp.broadcast_to(fdf, (B, obsdim)),
            goal_f,
        )

    def backward_pass(Jx, Ju, xs, us, cp):
        if use_bq_kernel:
            from ..ops.pallas_riccati import pallas_tvlqr_backward_quad

            Qd, Rd, Fd, goal_q = diag_cost_rows(cp, xs.shape[0])
            return pallas_tvlqr_backward_quad(
                Jx, Ju, xs, us, Qd, Rd, Fd, goal_q, dt, obsdim,
                interpret=pallas_interpret,
            )
        Vn, vn = jax.vmap(term_one)(xs[:, H], cp)
        Cxx, Cuu, cx, cu = jax.vmap(expansions_one)(xs, us, cp)
        if backward == "assoc":
            return jax.vmap(tvlqr_backward_assoc)(
                Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn
            )
        return jax.vmap(
            lambda *a: tvlqr_backward_scan(*a, unroll=unroll)
        )(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)

    def fused_line_search(pp, c, Ks, ks, lin_red, quad_red, ks_small):
        """The line-search kernel: (new_xs, new_us, new_obj, ls_success,
        failed[, Jx, Ju]) — the Jacobians only when the library has
        analytic term gradients."""
        from ..ops.pallas_linesearch import pallas_fused_line_search

        library, coeffs_key = feature_spec
        fns_a, gts_a, sel = _active_terms(library)
        cp = c["cost"]
        B = c["x0s"].shape[0]
        if quad_cost_batch:
            cost_args = (cp["Qdiag"], cp["Rdiag"], cp["Fdiag"], goal)
            reg_args = (
                (Sreg, mureg, cp["regw"]) if reg_matrix is not None
                else None
            )
        elif fixed_diag is not None:
            cost_args = diag_cost_rows(cp, B)
            reg_args = None
        else:
            g = getattr(cost, "_goal", None)
            cost_args = (
                cost._Q, cost._R, cost._F,
                jnp.zeros(obsdim) if g is None else g,
            )
            reg_args = None
        lo = umin if ubounds is not None else jnp.full((dc,), -jnp.inf)
        hi = umax if ubounds is not None else jnp.full((dc,), jnp.inf)
        return pallas_fused_line_search(
            fns_a, c["x0s"], c["xs"], c["us"], Ks, ks,
            sel(pp[coeffs_key]), alphas_static, lo, hi,
            *cost_args, dt, c["obj"], lin_red, quad_red, ks_small,
            grad_terms=gts_a,
            ls_cost_threshold=ls_cost_threshold,
            diag_cost=quad_cost_batch or fixed_diag is not None,
            reg=reg_args,
            interpret=pallas_interpret,
        )

    def xla_line_search(pp, c, Ks, ks, lin_red, quad_red, ks_small):
        x0s, xs, us, cp = c["x0s"], c["xs"], c["us"], c["cost"]
        if horizon_mask:
            ls_xs, ls_us = jax.vmap(
                line_search_one_m, in_axes=(p_ax, 0, 0, 0, 0, 0, 0),
            )(pp, x0s, xs, us, Ks, ks, cp["heff"])
        else:
            ls_xs, ls_us = jax.vmap(
                line_search_one, in_axes=(p_ax, 0, 0, 0, 0, 0)
            )(pp, x0s, xs, us, Ks, ks)
        new_objs = jax.vmap(
            lambda xs_l, us_l, cp1: jax.vmap(
                lambda a, b: eval_obj_one(a, b, cp1)
            )(xs_l, us_l)
        )(ls_xs, ls_us, cp)
        expect = alphas[None, :] * lin_red[:, None] + (
            alphas[None, :] ** 2
        ) * quad_red[:, None] / 2
        denom = -expect
        ratios = jnp.where(
            jnp.abs(denom) > 1e-30,
            (c["obj"][:, None] - new_objs) / denom,
            -jnp.inf,
        )
        accept = ratios > ls_cost_threshold
        any_acc = jnp.any(accept, axis=1)
        first_acc = jnp.argmax(accept, axis=1)
        # First acceptor wins; otherwise argmin over objectives; with a
        # tiny k only alpha 0 is ever evaluated (ilqr.py:208-225).
        chosen = jnp.where(
            ks_small, 0,
            jnp.where(any_acc, first_acc, jnp.argmin(new_objs, axis=1)),
        )
        take = jax.vmap(lambda a, i: a[i])
        best_obj = take(new_objs, chosen)
        ls_success = (best_obj < c["obj"]) | ks_small
        idx_last = jnp.where(
            ks_small, 0, jnp.where(any_acc, first_acc, ls_max_iter - 1)
        )
        last_obj = take(new_objs, idx_last)
        failed_now = (~ls_success) & (last_obj > c["obj"] + 1e-3)
        sel = jnp.where(ls_success, chosen, idx_last)
        new_obj = jnp.where(ls_success, best_obj, last_obj)
        return (take(ls_xs, sel), take(ls_us, sel), new_obj, ls_success,
                failed_now)

    def relinearize_batch(pp, xs, us, cp):
        Jx, Ju = jax.vmap(relinearize_one, in_axes=(p_ax, 0, 0))(pp, xs, us)
        if horizon_mask:
            # Padded steps relinearize as (I, 0): the frozen dynamics'
            # exact Jacobian (see the horizon_mask doc).
            mB = (_tsteps[None, :] < cp["heff"][:, None])[..., None, None]
            Jx = jnp.where(mB, Jx, jnp.eye(ds, dtype=Jx.dtype))
            Ju = jnp.where(mB, Ju, jnp.zeros_like(Ju))
        return Jx, Ju

    @highest_precision
    def make_carry0(params, x0s, uguess, cost_params=None):
        B = x0s.shape[0]
        cp = cost_params if quad_cost_batch else {}
        if quad_cost_batch and cost_params is None:
            raise ValueError("quad_cost_batch solve needs cost_params")
        if horizon_mask:
            xs0, Jx0, Ju0 = jax.vmap(
                forward_one_m, in_axes=(p_ax, 0, 0, 0)
            )(params, x0s, uguess, cp["heff"])
        else:
            xs0, Jx0, Ju0 = jax.vmap(forward_one, in_axes=(p_ax, 0, 0))(
                params, x0s, uguess
            )
        obj0 = jax.vmap(eval_obj_one)(xs0, uguess, cp)
        return dict(
            x0s=x0s, cost=cp,
            **({"params": params} if batch_params else {}),
            xs=xs0, us=uguess, Jx=Jx0, Ju=Ju0, obj=obj0,
            Ks=jnp.zeros((B, H, dc, ds)), ks=jnp.zeros((B, H, dc)),
            itr=jnp.array(0),
            converged=jnp.zeros(B, dtype=bool),
            failed=jnp.zeros(B, dtype=bool),
            done_itr=jnp.zeros(B, dtype=jnp.int32),
        )

    def cond(c):
        active = ~c["converged"] & ~c["failed"]
        return (c["itr"] < max_iter) & jnp.any(active)

    def make_body(params):
        @highest_precision
        def body(c):
            xs, us = c["xs"], c["us"]
            cp = c["cost"]
            # Per-lane params ride the carry so compaction gathers their
            # rows together with the trajectories.
            pp = c["params"] if batch_params else params
            active = ~c["converged"] & ~c["failed"]

            Ks, ks, lin_red, quad_red = backward_pass(
                c["Jx"], c["Ju"], xs, us, cp
            )
            ks_small = jnp.sqrt(jnp.sum(ks**2, axis=(1, 2))) < u_threshold

            ls = fused_line_search if use_ls_kernel else xla_line_search
            outs = ls(pp, c, Ks, ks, lin_red, quad_red, ks_small)
            new_xs, new_us, new_obj, ls_success, failed_now = outs[:5]
            if len(outs) > 5:
                Jx_lin, Ju_lin = outs[5:]
            else:
                Jx_lin, Ju_lin = relinearize_batch(pp, new_xs, new_us, cp)
            # Jacobians are only re-linearized after a successful line
            # search (ilqr.py:236-240).
            succ = ls_success[:, None, None, None]
            Jx_new = jnp.where(succ, Jx_lin, c["Jx"])
            Ju_new = jnp.where(succ, Ju_lin, c["Ju"])

            du_norm = jnp.sqrt(jnp.sum((new_us - us) ** 2, axis=(1, 2)))
            converged_now = (du_norm < u_threshold) & ~failed_now

            def upd(new, old, fail_mask):
                extra = (1,) * (new.ndim - 1)
                act = active.reshape((-1,) + extra)
                fl = fail_mask.reshape((-1,) + extra)
                return jnp.where(act & ~fl, new, old)

            no_fail = jnp.zeros_like(failed_now)
            finished_now = active & (converged_now | failed_now)
            return dict(
                x0s=c["x0s"], cost=cp,
                **({"params": pp} if batch_params else {}),
                xs=upd(new_xs, xs, failed_now),
                us=upd(new_us, us, failed_now),
                Jx=upd(Jx_new, c["Jx"], failed_now),
                Ju=upd(Ju_new, c["Ju"], failed_now),
                obj=upd(new_obj, c["obj"], failed_now),
                Ks=upd(Ks, c["Ks"], no_fail),
                ks=upd(ks, c["ks"], no_fail),
                itr=c["itr"] + 1,
                converged=c["converged"] | (converged_now & active),
                failed=c["failed"] | (failed_now & active),
                done_itr=jnp.where(
                    finished_now, jnp.int32(c["itr"] + 1), c["done_itr"]
                ),
            )

        return body

    def finalize(out):
        """Carry -> the public (converged, xs, us, Ks, ks) contract."""
        return (out["converged"], out["xs"], out["us"], out["Ks"],
                out["ks"])

    def solve(params, x0s, uguess, cost_params=None):
        carry0 = make_carry0(params, x0s, uguess, cost_params)
        out = jax.lax.while_loop(cond, make_body(params), carry0)
        return finalize(out)

    solve._finalize = finalize
    if return_pieces:
        return solve, make_carry0, cond, make_body
    return solve


def _batch_gather(tree, idx, B):
    """Gather rows ``idx`` from every batch-axis leaf (those whose
    first dim equals ``B``); other leaves (scalars like ``itr``) pass
    through. Shared by the staged and scheduled compaction drivers."""

    def g(a):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == B:
            return a[idx]
        return a

    return jax.tree_util.tree_map(g, tree)


def _batch_scatter(full, front, idx, B):
    """Inverse of ``_batch_gather``: write ``front``'s rows back at
    ``idx`` in every batch-axis leaf of ``full``; non-batch leaves
    take the front's value (e.g. ``itr`` — the front ran longest)."""

    def s(f, fr):
        if getattr(f, "ndim", 0) >= 1 and f.shape[0] == B:
            return f.at[idx].set(fr)
        return fr

    return jax.tree_util.tree_map(s, full, front)


def make_staged_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    chunk_iters: int = 5,
    min_bucket: int = 1024,
    max_iter: int = 50,
    **kwargs,
):
    """Batched iLQR with host-staged converged-lane compaction.

    Same contract as ``make_batched_ilqr_solver`` — ``solve(params,
    x0s (B,ds), uguess (B,H,dc)) -> (converged, xs, us, Ks, ks)`` with
    per-lane results identical to the single while_loop version (lanes
    are independent; compaction only changes which lanes share a
    dispatch) — but instead of running every lane for as many
    iterations as the *slowest* lane in the batch, the outer iteration
    runs in jitted chunks of ``chunk_iters``; between chunks the host
    reads the (tiny) finished mask, scatters finished lanes into the
    output buffers, and gathers the survivors into the smallest
    power-of-two bucket >= the survivor count (>= ``min_bucket``).
    On swing-up workloads the convergence histogram is long-tailed
    (median ~1/3 of the slowest lane), so the single-program batch
    spends ~40% of its iteration-FLOPs on already-converged lanes;
    compaction recovers most of that at the price of one compile per
    bucket size (persistent-cached) and one ~B-byte host sync per
    chunk.

    Not itself jittable (host control flow) — this is a top-level
    driver, the moral analog of the reference's per-config Python loop
    (autompc/control/ilqr.py:160-248), except each chunk is a fused
    device program over the surviving batch.
    """
    _, make_carry0, cond, make_body = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, max_iter=max_iter, return_pieces=True, **kwargs,
    )

    @partial(jax.jit, static_argnums=2)
    def run_chunk(params, carry, n):
        body = make_body(params)

        def cond2(cl):
            c, l = cl
            return cond(c) & (l < n)

        def body2(cl):
            c, l = cl
            return body(c), l + 1

        c, _ = jax.lax.while_loop(cond2, body2, (carry, jnp.array(0)))
        return c

    init = jax.jit(make_carry0)

    def _bucket(n_active, cur):
        # Smallest power of two >= n_active, clamped to [min_bucket, cur].
        b = 1 << max(0, int(np.ceil(np.log2(max(1, n_active)))))
        return min(cur, max(b, min_bucket))

    def solve_staged(params, x0s, uguess, cost_params=None):
        B = x0s.shape[0]
        carry = init(params, x0s, uguess, cost_params)
        idx = np.arange(B)  # original lane index per slot; -1 = padding
        out = dict(
            converged=jnp.zeros(B, dtype=bool),
            xs=jnp.zeros((B, H + 1, ds), dtype=x0s.dtype),
            us=jnp.zeros((B, H, dc), dtype=x0s.dtype),
            Ks=jnp.zeros((B, H, dc, ds), dtype=x0s.dtype),
            ks=jnp.zeros((B, H, dc), dtype=x0s.dtype),
        )

        def flush(local_slots):
            gi = idx[local_slots]
            for key in out:
                out[key] = out[key].at[jnp.asarray(gi)].set(
                    carry[key][jnp.asarray(local_slots)]
                )

        while True:
            carry = run_chunk(params, carry, chunk_iters)
            done = np.asarray(carry["converged"] | carry["failed"])
            itr = int(carry["itr"])
            real = idx >= 0
            active = real & ~done
            n_active = int(active.sum())
            if n_active == 0 or itr >= max_iter:
                flush(np.where(real)[0])
                break
            cur = len(idx)
            nb = _bucket(n_active, cur)
            if nb < cur:
                flush(np.where(real & done)[0])
                act_loc = np.where(active)[0]
                # Pad with finished slots: inactive under the masks, so
                # they do no work and produce no output (idx -1).
                pad_loc = np.where(done)[0][: nb - n_active]
                sel = np.concatenate([act_loc, pad_loc])
                carry = _batch_gather(carry, jnp.asarray(sel), cur)
                idx = np.concatenate(
                    [idx[act_loc], np.full(nb - n_active, -1, dtype=int)]
                )

        return (
            out["converged"], out["xs"], out["us"], out["Ks"], out["ks"]
        )

    return solve_staged


def parse_schedule(s):
    """Parse a compaction schedule string ``"cut:frac,cut:frac,..."``
    (e.g. ``"20:0.5,38:0.25"``) into the ``((cut_iter, size_frac), ...)``
    tuples ``make_scheduled_ilqr_solver`` takes. Empty/None -> None."""
    if not s:
        return None
    out = []
    for chunk in s.split(","):
        cut, frac = chunk.split(":")
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(
                f"schedule size_frac must be in (0, 1], got {frac}"
            )
        out.append((int(cut), frac))
    return tuple(out)


def make_scheduled_ilqr_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds=None,
    schedule=((20, 0.5), (38, 0.25)),
    max_iter: int = 50,
    **kwargs,
):
    """Batched iLQR with **device-side** converged-lane compaction.

    Same contract as ``make_batched_ilqr_solver`` and fully jittable —
    one device program, zero host round-trips (unlike
    ``make_staged_ilqr_solver``, which reads the finished mask on the
    host between chunks). The convergence histogram of the swing-up workload is
    long-tailed (median lane ~15 of the slowest lane's ~50 iterations,
    ~63%% of lane-iteration work wasted), so the solve follows a static
    compaction ``schedule``: a list of ``(cut_iter, size_frac)`` with
    ``size_frac`` relative to the ORIGINAL batch size. At each cut,
    lanes are stably sorted by their done flag (active lanes first)
    and, **if** the active count fits, the front ``size_frac * B``
    lanes continue alone — the backward pass, line search, and
    relinearization all shrink — and are scattered back at the end.
    If the actives overflow the bucket (workload shifted), a
    ``lax.cond`` stays at the current size but keeps the later cuts
    alive: the schedule is a performance hint, never a correctness
    bound. ``parse_schedule`` turns the ``"cut:frac,..."`` string the
    bench harnesses use into this form.

    Per-lane trajectories are unchanged by compaction (lanes are
    independent; on an accelerator, reductions may be ordered
    differently at different batch shapes, so borderline convergence
    flags can differ by float noise — the same caveat as any batch-size
    change).

    Default schedule from the measured cartpole-swing-up distribution
    (done-fraction ~66%% by iteration 20, ~90%% by 38): expected cost
    20 + 18/2 + 12/4 = 32 B-iterations vs 50 for the single-program
    batch.
    """
    solve0, make_carry0, cond, make_body = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, max_iter=max_iter, return_pieces=True, **kwargs,
    )

    def solve(params, x0s, uguess, cost_params=None):
        B = x0s.shape[0]
        body = make_body(params)

        def run_until(carry, upto):
            def cond2(c):
                return cond(c) & (c["itr"] < upto)

            return jax.lax.while_loop(cond2, body, carry)

        def recurse(carry, sched):
            B_cur = carry["converged"].shape[0]
            if not sched:
                return run_until(carry, max_iter)
            cut, frac = sched[0]
            # size_frac is relative to the ORIGINAL batch size, so a
            # schedule reads as absolute bucket sizes regardless of how
            # many earlier cuts were taken (or skipped via overflow).
            B_next = max(1, int(round(B * frac)))
            if B_next >= B_cur:
                return recurse(carry, sched[1:])
            carry = run_until(carry, cut)
            done = carry["converged"] | carry["failed"]
            n_active = jnp.sum(~done)
            perm = jnp.argsort(done, stable=True)
            front_idx = perm[:B_next]

            def compacted(carry):
                front = _batch_gather(carry, front_idx, B_cur)
                front = recurse(front, sched[1:])
                return _batch_scatter(carry, front, front_idx, B_cur)

            def overflow(carry):
                # Actives don't fit this bucket: stay at the current
                # size but keep the LATER cuts alive — one early
                # overflow shouldn't forfeit the rest of the schedule.
                # (Both branches of every cond are compiled, so the
                # program grows with 2^len(schedule) run_until
                # instantiations; fine for the 2-4 stage schedules in
                # use.)
                return recurse(carry, sched[1:])

            return jax.lax.cond(
                n_active <= B_next, compacted, overflow, carry
            )

        carry = make_carry0(params, x0s, uguess, cost_params)
        out = recurse(carry, tuple(schedule))
        return solve0._finalize(out)

    return solve


class IterativeLQRFactory(ControllerFactory):
    """Hyperparameters (ilqr.py:36-41):

    - *horizon* (int, 5..25, default 20): MPC optimization horizon.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = IterativeLQR
        self.name = "IterativeLQR"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=5, upper=25, default_value=20)
        )
        return cs


class IterativeLQR(Controller):
    def __init__(
        self,
        system,
        task,
        model,
        horizon,
        reuse_feedback=-1,
        ubounds=None,
        mode=None,
        verbose=False,
    ):
        """``reuse_feedback`` steps of the cached feedback gains are
        replayed before recomputing (0 = recompute every step; reference
        ilqr.py:44-63). ``mode`` None uses control clipping; the
        reference declares barrier/auglag modes but never implements
        them (ilqr.py:69-76)."""
        super().__init__(system, task, model)
        self.horizon = int(horizon)
        if reuse_feedback is None or reuse_feedback <= 0:
            self.reuse_feedback = 0
        elif reuse_feedback > self.horizon:
            self.reuse_feedback = self.horizon
        else:
            self.reuse_feedback = int(reuse_feedback)
        if mode not in (None, "barrier", "auglag"):
            raise ValueError("mode has to be None/barrier/auglag")
        if ubounds is None and task.are_ctrl_bounded():
            bounds = task.get_ctrl_bounds()
            ubounds = (bounds[:, 0], bounds[:, 1])
        self.ubounds = ubounds
        self._model_params = model.params
        self._solve = make_ilqr_solver(
            model.pred_core,
            task.get_cost(),
            H=self.horizon,
            ds=model.state_dim,
            dc=system.ctrl_dim,
            obsdim=system.obs_dim,
            dt=system.dt,
            ubounds=ubounds,
            # Models exposing a closed-form Jacobian (MLP's layer
            # chain, sysid/mlp.py:pred_diff_core) skip jacfwd's
            # per-input tangent pushforwards in the forward/relin
            # phases.
            pred_diff=getattr(model, "pred_diff_core", None),
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return (
            task.get_cost().is_quad
            and not task.are_obs_bounded()
            and not task.eq_cons_present()
            and not task.ineq_cons_present()
        )

    def traj_to_state(self, traj):
        H, dc, ds = self.horizon, self.system.ctrl_dim, self.model.state_dim
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=jnp.asarray(traj[-1].ctrl),
            xs=jnp.zeros((H + 1, ds)),
            us=jnp.zeros((H, dc)),
            Ks=jnp.zeros((H, dc, ds)),
            ks=jnp.zeros((H, dc)),
            step_count=jnp.array(0),
            need_recompute=jnp.array(True),
        )

    def step(self, cstate, new_obs):
        params = self._model_params
        H, dc = self.horizon, self.system.ctrl_dim
        state = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs
        )

        if self.reuse_feedback == 0:
            # Recompute every step (default path) — no caching branch.
            _, xs, us, Ks, ks = self._solve(params, state, jnp.zeros((H, dc)))
            u = us[0] + Ks[0] @ (state - xs[0])
            return u, dict(
                cstate,
                model_state=state,
                last_u=u,
                xs=xs, us=us, Ks=Ks, ks=ks,
            )

        def recompute(_):
            _, xs, us, Ks, ks = self._solve(params, state, jnp.zeros((H, dc)))
            return xs, us, Ks, ks, jnp.array(0)

        def cached(_):
            return (
                cstate["xs"], cstate["us"], cstate["Ks"], cstate["ks"],
                cstate["step_count"],
            )

        xs, us, Ks, ks, step_count = jax.lax.cond(
            cstate["need_recompute"], recompute, cached, None
        )
        u = us[step_count] + Ks[step_count] @ (state - xs[step_count])
        step_next = step_count + 1
        # Recompute when the cached gain budget is exhausted
        # (ilqr.py:285-288).
        need_next = step_next >= self.reuse_feedback
        return u, dict(
            model_state=state,
            last_u=u,
            xs=xs, us=us, Ks=Ks, ks=ks,
            step_count=step_next,
            need_recompute=need_next,
        )

    # -- reference-parity one-shot solve -------------------------------
    def compute_ilqr(self, state, uguess, **kwargs):
        """Direct access to the underlying solve (ilqr.py:100 API):
        returns (converged, states, ctrls, Ks, ks)."""
        return jax.jit(self._solve)(
            self._model_params, jnp.asarray(state), jnp.asarray(uguess)
        )
