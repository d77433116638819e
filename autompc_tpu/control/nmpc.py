"""Direct transcription MPC via device-resident SQP.

Re-creates the reference's direct-transcription controller (reference:
autompc/control/nmpc.py:36-327): a knot-point NLP over states
``x_0..x_H`` and controls ``u_0..u_{H-1}`` with Euler dynamics defect
constraints, warm-started from the previous MPC step's solution, ~10
solver iterations per step.

Where the reference hands the NLP to IPOPT (C++ via cyipopt,
nmpc.py:283-298) with Python callbacks per inner iteration, this
implementation runs a **sequential quadratic programming loop fully on
device**: each SQP iterate linearizes the dynamics, solves the
equality-constrained trajectory QP through its block-tridiagonal KKT
factorization (ops/trajqp.py — one backward + one forward scan), and
globalizes with an L1-merit backtracking line search. Control bounds are
enforced by projection, matching the reference solvers' clipping
convention. The whole MPC step jits and fuses with the surrounding
closed-loop scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..ops.riccati import highest_precision
from ..ops.trajqp import qp_backward, qp_forward
from .controller import Controller, ControllerFactory


class DirectTranscriptionControllerFactory(ControllerFactory):
    """Hyperparameters (nmpc.py:234-239):

    - *horizon* (int, 1..30, default 10): control horizon **in seconds**;
      knot count = ceil(horizon / dt) (nmpc.py:254).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = DirectTranscriptionController
        self.name = "DirectTranscription"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=1, upper=30, default_value=10)
        )
        return cs


def make_sqp_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds,
    sqp_iters: int = 10,
    ls_max_iter: int = 8,
    merit_mu: float = 100.0,
    reg: float = 1e-7,
    backward: str = "scan",
    pred_diff=None,
    xbounds=None,
    xbound_mu: float = 100.0,
    xbound_lam_every: int = 4,
):
    """Build ``solve(params, x0, xs_guess, us_guess) -> (xs, us)``.

    ``backward``: "scan" (sequential KKT factorization) or "assoc"
    (O(log H)-depth associative-scan Riccati with defects,
    ops/trajqp.py:qp_backward_assoc — the long-horizon option).

    Objective semantics mirror NonLinearMPCProblem.get_cost
    (nmpc.py:73-83): ``dt * sum_{i=0..H} obs_cost(x_i) + dt *
    sum_{i<H} ctrl_cost(u_i) + term_cost(x_H)``; defects are
    ``f(x_i, u_i) - x_{i+1}`` (nmpc.py:102-110).

    ``xbounds``: optional ``(lo, hi)`` arrays of shape (obsdim,) —
    observation box constraints on every knot state. The reference
    imposes these as IPOPT decision-variable bounds
    (nmpc.py:121-130: xlb/xub from task.get_obs_bounds()); here they
    are enforced by an **augmented Lagrangian** on the two one-sided
    constraints per coordinate: each SQP iterate's stage expansion
    carries the AL term's gradient/diagonal Hessian (a semi-smooth
    Newton step on the AL subproblem), the L1 merit carries the AL
    penalty so the line search respects feasibility progress, and the
    multipliers update ``lam <- max(0, lam + mu g)`` every
    ``xbound_lam_every`` iterations — NOT every step: updating the
    dual before the primal subproblem is approximately solved makes
    primal and dual chase each other (measured: peak violation cycled
    0.5..1.5x the bound with per-step updates; converges exactly to
    the bound with updates every 2-8 steps). Infinite entries
    deactivate a side.
    """
    umin = jnp.asarray(ubounds[0])
    umax = jnp.asarray(ubounds[1])

    has_xbounds = xbounds is not None
    if has_xbounds:
        # Replace infinities so the hinge terms are traced but never
        # activate on unbounded coordinates.
        xlo = jnp.where(
            jnp.isfinite(jnp.asarray(xbounds[0])), jnp.asarray(xbounds[0]),
            -1e9,
        )
        xhi = jnp.where(
            jnp.isfinite(jnp.asarray(xbounds[1])), jnp.asarray(xbounds[1]),
            1e9,
        )
        mu_x = xbound_mu

    def clip_u(u):
        return jnp.clip(u, umin, umax)

    def objective(xs, us):
        oc = jnp.sum(jax.vmap(lambda x: cost.eval_obs_cost(x[:obsdim]))(xs))
        cc = jnp.sum(jax.vmap(cost.eval_ctrl_cost)(us))
        return dt * (oc + cc) + cost.eval_term_obs_cost(xs[H, :obsdim])

    def defects(params, xs, us):
        preds = jax.vmap(lambda x, u: pred_core(params, x, u))(xs[:H], us)
        return preds - xs[1:]

    if has_xbounds:
        # Knot 0 is pinned to the measured state; its bound violation is
        # not a decision (mask keeps its multipliers at zero and its
        # penalty out of the merit).
        knot_w = jnp.ones(H + 1).at[0].set(0.0)

        def al_terms(x, lam_lo_i, lam_hi_i, w):
            """Penalty value, gradient, and diagonal Hessian of the
            augmented-Lagrangian treatment of lo <= x[:obsdim] <= hi at
            one knot (standard PHR form: for g <= 0 with multiplier
            lam, P = (max(0, lam + mu g)^2 - lam^2) / (2 mu))."""
            xo = x[:obsdim]
            t_hi = jnp.maximum(0.0, lam_hi_i + mu_x * (xo - xhi)) * w
            t_lo = jnp.maximum(0.0, lam_lo_i + mu_x * (xlo - xo)) * w
            pen = (
                jnp.sum(t_hi**2 - (lam_hi_i * w) ** 2)
                + jnp.sum(t_lo**2 - (lam_lo_i * w) ** 2)
            ) / (2.0 * mu_x)
            grad = t_hi - t_lo
            hdiag = mu_x * (
                (t_hi > 0).astype(x.dtype) + (t_lo > 0).astype(x.dtype)
            )
            return pen, grad, hdiag

        def al_penalty_total(xs, lam_lo, lam_hi):
            pens, _, _ = jax.vmap(al_terms)(xs, lam_lo, lam_hi, knot_w)
            return jnp.sum(pens)

    def merit(params, xs, us, lam_lo=None, lam_hi=None):
        m = objective(xs, us) + merit_mu * jnp.sum(
            jnp.abs(defects(params, xs, us))
        )
        if has_xbounds:
            m = m + al_penalty_total(xs, lam_lo, lam_hi)
        return m

    def linearize(params, xs, us):
        if pred_diff is not None:
            # Closed-form model Jacobians (e.g. MLP.pred_diff_core) —
            # same option as make_batched_ilqr_solver's ``pred_diff``.
            def one_pd(x, u):
                _, jx, ju = pred_diff(params, x, u)
                return jx, ju

            return jax.vmap(one_pd)(xs[:H], us)

        def one(x, u):
            jx = jax.jacfwd(lambda s: pred_core(params, s, u))(x)
            ju = jax.jacfwd(lambda uu: pred_core(params, x, uu))(u)
            return jx, ju

        return jax.vmap(one)(xs[:H], us)

    def stage_expansions(xs, us):
        def one(x, u):
            _, qx, Qh = cost.eval_obs_cost_hess(x[:obsdim])
            _, ru, Rh = cost.eval_ctrl_cost_hess(u)
            Cxx = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(Qh * dt)
            cx = jnp.zeros(ds).at[:obsdim].set(qx * dt)
            return Cxx, Rh * dt, cx, ru * dt

        return jax.vmap(one)(xs[:H], us)

    alphas = 0.5 ** jnp.arange(ls_max_iter)

    def sqp_iteration(carry, it):
        if has_xbounds:
            params, xs, us, lam_lo, lam_hi = carry
        else:
            params, xs, us = carry
            lam_lo = lam_hi = None
        A_seq, B_seq = linearize(params, xs, us)
        d_seq = defects(params, xs, us)
        Cxx, Cuu, cx, cu = stage_expansions(xs, us)
        Cux = jnp.zeros((H, dc, ds))
        # Terminal expansion includes the knot's own stage cost plus the
        # terminal cost (nmpc.py:78-82: obs cost runs over i=0..H).
        _, tg, th = cost.eval_term_obs_cost_hess(xs[H, :obsdim])
        _, sg, sh = cost.eval_obs_cost_hess(xs[H, :obsdim])
        Vf = jnp.zeros((ds, ds)).at[:obsdim, :obsdim].set(th + sh * dt)
        vf = jnp.zeros(ds).at[:obsdim].set(tg + sg * dt)

        if has_xbounds:
            # AL gradient / diagonal Hessian of the box terms enters the
            # QP expansions (NOT dt-scaled: the reference treats bounds
            # as hard variable bounds, not stage costs).
            _, g_all, h_all = jax.vmap(al_terms)(xs, lam_lo, lam_hi, knot_w)
            Cxx = Cxx.at[:, jnp.arange(obsdim), jnp.arange(obsdim)].add(
                h_all[:H]
            )
            cx = cx.at[:, :obsdim].add(g_all[:H])
            Vf = Vf.at[jnp.arange(obsdim), jnp.arange(obsdim)].add(h_all[H])
            vf = vf.at[:obsdim].add(g_all[H])

        if backward == "assoc":
            from ..ops.trajqp import qp_backward_assoc

            Ks, ks, _, _ = qp_backward_assoc(
                A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg
            )
        else:
            Ks, ks, _, _ = qp_backward(
                A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg
            )

        merit0 = merit(params, xs, us, lam_lo, lam_hi)

        def try_alpha(alpha):
            dxs, dus = qp_forward(A_seq, B_seq, d_seq, Ks, ks, alpha=alpha)
            xs_new = xs + dxs
            us_new = clip_u(us + dus)
            return xs_new, us_new, merit(params, xs_new, us_new, lam_lo,
                                         lam_hi)

        xs_c, us_c, merits = jax.vmap(try_alpha)(alphas)
        improved = merits < merit0
        # First improving alpha; if none improve, keep the iterate.
        idx = jnp.argmax(improved)
        any_imp = jnp.any(improved)
        xs_next = jnp.where(any_imp, xs_c[idx], xs)
        us_next = jnp.where(any_imp, us_c[idx], us)
        if has_xbounds:
            # First-order multiplier update on the accepted iterate —
            # only every xbound_lam_every-th iteration, once the inner
            # semi-smooth Newton steps have approximately solved the
            # current AL subproblem (see docstring).
            do_update = (it % xbound_lam_every) == (xbound_lam_every - 1)
            xo = xs_next[:, :obsdim]
            lam_hi_new = jnp.maximum(
                0.0, lam_hi + mu_x * (xo - xhi)
            ) * knot_w[:, None]
            lam_lo_new = jnp.maximum(
                0.0, lam_lo + mu_x * (xlo - xo)
            ) * knot_w[:, None]
            lam_hi = jnp.where(do_update, lam_hi_new, lam_hi)
            lam_lo = jnp.where(do_update, lam_lo_new, lam_lo)
            return (params, xs_next, us_next, lam_lo, lam_hi), merits[idx]
        return (params, xs_next, us_next), merits[idx]

    @highest_precision
    def solve(params, x0, xs_guess, us_guess):
        xs = xs_guess.at[0].set(x0)
        if has_xbounds:
            lam0 = jnp.zeros((H + 1, obsdim))
            carry = (params, xs, us_guess, lam0, lam0)
        else:
            carry = (params, xs, us_guess)
        out, _ = jax.lax.scan(
            sqp_iteration, carry, jnp.arange(sqp_iters)
        )
        return out[1], out[2]

    return solve


class DirectTranscriptionController(Controller):
    def __init__(self, system, task, model, horizon):
        super().__init__(system, task, model)
        # Reference converts the horizon hyperparameter (seconds) to knot
        # count (nmpc.py:254).
        self.horizon = int(np.ceil(horizon / system.dt))
        bounds = task.get_ctrl_bounds()
        finite_lo = np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -1e9)
        finite_hi = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1e9)
        # Observation box constraints become knot-state bounds, as the
        # reference's IPOPT variable bounds (nmpc.py:121-130: xlb/xub
        # from task.get_obs_bounds()); enforced here by the SQP's
        # augmented-Lagrangian box treatment.
        xbounds = None
        if task.are_obs_bounded():
            ob = task.get_obs_bounds()
            xbounds = (ob[:, 0], ob[:, 1])
        self._model_params = model.params
        self._solve = make_sqp_solver(
            model.pred_core,
            task.get_cost(),
            H=self.horizon,
            ds=model.state_dim,
            dc=system.ctrl_dim,
            obsdim=system.obs_dim,
            dt=system.dt,
            ubounds=(finite_lo, finite_hi),
            pred_diff=getattr(model, "pred_diff_core", None),
            xbounds=xbounds,
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return True

    def traj_to_state(self, traj):
        H, ds, dc = self.horizon, self.model.state_dim, self.system.ctrl_dim
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=jnp.asarray(traj[-1].ctrl),
            xs_guess=jnp.zeros((H + 1, ds)),
            us_guess=jnp.zeros((H, dc)),
        )

    def set_guess(self, cstate, us_guess, xs_guess=None):
        """Return a controller state whose next solve warm-starts from the
        given knot-point guess (reference nmpc.py:263-266 ``set_guess``;
        functional here — warm starts live in the controller-state pytree,
        not on the object).

        ``us_guess``: (H, ctrl_dim) control knots. ``xs_guess``: optional
        (H+1, state_dim) state knots; if omitted, states are filled by
        rolling the model forward from the current model state under
        ``us_guess`` (the reference's flat decision vector packs both).
        """
        H, ds, dc = self.horizon, self.model.state_dim, self.system.ctrl_dim
        us_guess = jnp.asarray(us_guess, dtype=jnp.float32).reshape(H, dc)
        if xs_guess is None:
            params = self._model_params

            def roll(x, u):
                xn = self.model.pred_core(params, x, u)
                return xn, xn

            x0 = cstate["model_state"]
            _, tail = jax.lax.scan(roll, x0, us_guess)
            xs_guess = jnp.concatenate([x0[None], tail], axis=0)
        xs_guess = jnp.asarray(xs_guess, dtype=jnp.float32).reshape(H + 1, ds)
        return dict(cstate, xs_guess=xs_guess, us_guess=us_guess)

    def step(self, cstate, new_obs):
        params = self._model_params
        x = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs
        )
        xs, us = self._solve(params, x, cstate["xs_guess"], cstate["us_guess"])
        u = us[0]
        # Warm start next step from this solution (nmpc.py:319-320; the
        # reference does not shift the guess).
        return u, dict(
            model_state=x, last_u=u, xs_guess=xs, us_guess=us
        )
