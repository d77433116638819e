"""Tuning fan-out: evaluate batches of candidate configurations with one
sharded program.

This is the accelerator-native replacement for the reference's strictly
sequential SMAC objective (reference: autompc/tuning/pipeline_tuner.py:
213-271, one `pipeline(cfg) -> simulate -> cost` per iteration): for
configuration families whose hyperparameters do not change compiled
shapes (cost gains, solver temperatures/scales), the *entire* candidate
evaluation — controller synthesis (iLQR/MPPI solve) + closed-loop
surrogate rollout + metric — is one pure function, vmapped over the
candidate batch and sharded over the mesh's ``config`` axis. Thousands
of candidates evaluate in the time the reference takes for one.

Shape-changing hyperparameters (horizon, model sizes) are handled by
bucketing: one ``TuningFanout`` per shape signature
(config/space.py:shape_signature), compiled once and reused.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..control.ilqr import make_ilqr_solver
from ..costs import QuadCost
from ..utils.simulation import rollout_scan
from .mesh import make_mesh, pad_to_multiple, shard_vmap


def _validate_regw(batch, has_reg, cls_name):
    """Call-boundary validation of the GaussReg per-lane weight: a
    fan-out constructed with ``reg_matrix`` needs a ``regw`` lane array
    in every eval batch. Without this check a missing/ragged key
    surfaces as a raw KeyError (or shape error) from deep inside jit
    tracing."""
    if not has_reg:
        return
    if "regw" not in batch:
        raise ValueError(
            f"{cls_name} was constructed with reg_matrix (GaussReg "
            "term); each eval batch must carry a 'regw' array of "
            "per-lane regularization weights, shape (B,)"
        )
    regw = batch["regw"]
    ref = next(
        (v for k, v in batch.items() if k != "regw" and hasattr(v, "shape")),
        None,
    )
    if hasattr(regw, "shape"):
        # 1-D is required unconditionally; the length check additionally
        # needs a reference lane array to compare against.
        if len(regw.shape) != 1:
            raise ValueError(
                f"{cls_name}: 'regw' must be a 1-D per-lane array of "
                f"shape (B,); got {tuple(regw.shape)}"
            )
        if ref is not None and regw.shape[0] != ref.shape[0]:
            raise ValueError(
                f"{cls_name}: 'regw' must have shape (B,) = "
                f"({ref.shape[0]},); got {tuple(regw.shape)}"
            )


class QuadCostFanout:
    """Evaluate a batch of diagonal quadratic-cost candidates (the
    QuadCostFactory search space, costs/quad_cost_factory.py) for a fixed
    model/surrogate pair, with an iLQR controller synthesized per
    candidate inside the traced program.

    ``__call__(params_batch)`` takes a dict of arrays with leading batch
    axis:
        Qdiag (B, n), Fdiag (B, n), Rdiag (B, m)
    and returns the per-candidate task cost of the closed-loop surrogate
    trajectory, shape (B,).

    ``impl="batched"`` (default) runs the whole candidate batch through
    ONE per-lane-cost iLQR solver per closed-loop step
    (control/ilqr.py:make_batched_ilqr_solver(quad_cost_batch=True)):
    the backward pass, line search, and relinearization see (B, ...)
    tensors — one batched program instead of vmap's lane-sliced loops over
    tiny (ds, ds) solves. ``impl="vmap"`` keeps the per-candidate
    vmapped solver (the reference-shaped formulation; used by the
    parity tests).
    """

    def __init__(
        self,
        system,
        task,
        model,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        impl: str = "batched",
        compact_schedule=None,
        backward: str = "auto",
        feature_spec=None,
        warm_start: bool = False,
        reg_matrix=None,
        reg_goal=None,
    ):
        # ``reg_matrix``/``reg_goal``: the GaussRegFactory term — the
        # candidate batch then additionally carries per-lane weights
        # ``regw (B,)`` and each lane's cost is the SumCost
        # ``diag-quad(task goal) + regw * (x-mu)' Sigma^-1 (x-mu)``
        # (make_batched_ilqr_solver's reg term). Batched impl only.
        if impl not in ("batched", "vmap"):
            raise ValueError(
                f"impl must be 'batched' or 'vmap', got {impl!r}"
            )
        if reg_matrix is not None and impl != "batched":
            raise ValueError("reg_matrix requires impl='batched'")
        self.system = system
        self.task = task
        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        ubounds = (bounds[:, 0], bounds[:, 1])
        task_cost = task.get_cost()

        model_params = model.params
        surr_params = surrogate.params
        ds = model.state_dim
        dc = system.ctrl_dim
        n = system.obs_dim
        # Initial controller-model state from the seed observation
        # (host-side precompute; the model is fixed across candidates).
        from ..core.trajectory import zeros as traj_zeros

        seed_traj = traj_zeros(system, 1).set_obs(0, init_obs)
        mstate0 = model.traj_to_state(seed_traj)

        if impl == "batched":
            from ..control.ilqr import (
                make_batched_ilqr_solver,
                make_scheduled_ilqr_solver,
            )

            # ``compact_schedule``: optional converged-lane compaction
            # cut points for the per-step solve (see
            # make_scheduled_ilqr_solver); pays off when the candidate
            # batch's solve-iteration histogram is long-tailed and B is
            # large enough that the argsort+gather is amortized.
            # ``backward`` / ``feature_spec`` as in
            # make_batched_ilqr_solver: the platform and the model pick
            # the kernels (a linear-in-features model declares itself
            # through ``feature_spec``).
            solver_kw = dict(
                H=horizon, ds=ds, dc=dc, obsdim=n,
                dt=system.dt, ubounds=ubounds, backward=backward,
                feature_spec=feature_spec,
                quad_cost_batch=True, quad_goal=goal,
            )
            if reg_matrix is not None:
                solver_kw["reg_matrix"] = jnp.asarray(reg_matrix)
                solver_kw["reg_goal"] = (
                    jnp.asarray(reg_goal) if reg_goal is not None else None
                )
            if feature_spec is not None:
                # The fan-out bakes model_params at construction (the
                # whole design assumes one fixed model per instance),
                # so static feature masking is sound here: skip the
                # library terms whose coefficient columns the STLSQ
                # threshold zeroed (see make_batched_ilqr_solver's
                # feature_mask; 7 of 55 live on the cartpole model).
                _, ckey = feature_spec
                cnp = np.asarray(model_params[ckey])
                live = np.flatnonzero(np.any(np.abs(cnp) > 0, axis=0))
                if 0 < live.size < cnp.shape[1]:
                    solver_kw["feature_mask"] = tuple(
                        int(k) for k in live
                    )
            if compact_schedule is not None:
                if isinstance(compact_schedule, str):
                    from ..control.ilqr import parse_schedule

                    compact_schedule = parse_schedule(compact_schedule)
                solve = make_scheduled_ilqr_solver(
                    model.pred_core, None,
                    schedule=tuple(compact_schedule), **solver_kw,
                )
            else:
                solve = make_batched_ilqr_solver(
                    model.pred_core, None, **solver_kw
                )
            def eval_batch(cost_params):
                B = cost_params["Qdiag"].shape[0]
                obs0 = jnp.broadcast_to(init_obs, (B, n))
                mst0 = jax.tree_util.tree_map(
                    lambda a: jnp.broadcast_to(a, (B,) + jnp.shape(a)),
                    mstate0,
                )

                def body(carry, _):
                    mstate, last_u, obs, us_prev = carry
                    state = jax.vmap(
                        lambda m, u, o: model.update_state_core(
                            model_params, m, u, o
                        )
                    )(mstate, last_u, obs)
                    if warm_start:
                        # Receding-horizon warm start: shift the
                        # previous step's solution one knot (beyond-
                        # parity option; the reference re-solves from
                        # zeros every step, ilqr.py:275).
                        uguess = jnp.concatenate(
                            [us_prev[:, 1:], us_prev[:, -1:]], axis=1
                        )
                    else:
                        uguess = jnp.zeros((B, horizon, dc))
                    _, xs, us, Ks, ks = solve(
                        model_params, state, uguess, cost_params,
                    )
                    u = us[:, 0] + jnp.einsum(
                        "bij,bj->bi", Ks[:, 0], state - xs[:, 0]
                    )
                    next_obs = jax.vmap(
                        lambda o, uu: surrogate.pred_core(
                            surr_params, o, uu
                        )[:n]
                    )(obs, u)
                    # Only carry the previous solution when it is read.
                    return (
                        state, u, next_obs, us if warm_start else us_prev
                    ), (obs, u)

                carry0 = (
                    mst0, jnp.zeros((B, dc)), obs0,
                    jnp.zeros((B, horizon if warm_start else 0, dc)),
                )
                (_, _, last_obs, _), (obs_seq, ctrl_seq) = jax.lax.scan(
                    body, carry0, None, length=n_steps
                )
                stage = jax.vmap(jax.vmap(task_cost.eval_obs_cost))(
                    obs_seq
                ).sum(axis=0) + jax.vmap(task_cost.eval_obs_cost)(last_obs)
                ctrlc = jax.vmap(jax.vmap(task_cost.eval_ctrl_cost))(
                    ctrl_seq
                ).sum(axis=0)
                term = jax.vmap(task_cost.eval_term_obs_cost)(last_obs)
                total = stage + ctrlc + term
                return jnp.where(jnp.isfinite(total), total, jnp.inf)

            if mesh is None:
                eval_jit = jax.jit(eval_batch)
                n_dev = 1
            else:
                # shard_map over the candidate axis: candidates are
                # independent, so EVERYTHING — the per-lane solve, the
                # compaction argsort+gather, the closed-loop scan — is
                # shard-local with zero collectives. (A plain sharded
                # jit would implement jnp.argsort over the global batch
                # axis with cross-device data movement; per-shard
                # while_loops are also free to take different trip
                # counts, which SPMD allows when nothing synchronizes.)
                from jax.sharding import PartitionSpec as P

                spec = P(mesh.axis_names[0])
                eval_jit = jax.jit(
                    jax.shard_map(
                        eval_batch, mesh=mesh,
                        in_specs=(spec,), out_specs=spec,
                        check_vma=False,
                    )
                )
                n_dev = int(np.prod(mesh.devices.shape))
            # Pad quantum: smallest multiple of the mesh size >= 8, so
            # shards stay equal AND ragged BO bucket occupancy reuses
            # one compiled program (this solver takes minutes to
            # compile cold) — the contract shard_vmap gives the
            # per-candidate path (parallel/mesh.py:pad_to_multiple).
            pad_quantum = n_dev * max(1, -(-8 // n_dev))

            def eval_padded(cost_params):
                padded, n_real = pad_to_multiple(cost_params, pad_quantum)
                return eval_jit(padded)[:n_real]

            self._eval = eval_padded
            return

        def eval_one(cost_params):
            cost = QuadCost(
                system,
                jnp.diag(cost_params["Qdiag"]),
                jnp.diag(cost_params["Rdiag"]),
                jnp.diag(cost_params["Fdiag"]),
                goal=goal,
            )
            solve = make_ilqr_solver(
                model.pred_core, cost,
                H=horizon, ds=ds, dc=dc, obsdim=n,
                dt=system.dt, ubounds=ubounds,
            )

            def ctrl_step(cstate, obs):
                mstate, last_u = cstate
                state = model.update_state_core(
                    model_params, mstate, last_u, obs
                )
                _, xs, us, Ks, ks = solve(
                    model_params, state, jnp.zeros((horizon, dc))
                )
                u = us[0] + Ks[0] @ (state - xs[0])
                return u, (state, u)

            def advance(obs, u):
                # Surrogate closed loop; obs-state surrogates only (the
                # fan-out path targets obs-state models; lifted-state
                # surrogates go through the general simulate()).
                return surrogate.pred_core(surr_params, obs, u)[:n]

            cstate0 = (mstate0, jnp.zeros(dc))
            all_obs, ctrl_seq, _ = rollout_scan(
                ctrl_step, advance, cstate0, init_obs, n_steps
            )
            # Task metric over the rollout (threshold costs trace fine).
            stage = jax.vmap(task_cost.eval_obs_cost)(all_obs).sum()
            ctrlc = jax.vmap(task_cost.eval_ctrl_cost)(ctrl_seq).sum()
            term = task_cost.eval_term_obs_cost(all_obs[-1])
            total = stage + ctrlc + term
            # Non-finite rollouts score +inf (bad config => tuning
            # continues; pipeline_tuner.py:236-239 contract).
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        self._eval = shard_vmap(eval_one, mesh=mesh)

    def __call__(self, params_batch):
        _validate_regw(
            params_batch, getattr(self, "_has_reg", False),
            type(self).__name__,
        )
        return self._eval(params_batch)


class JointSINDyQuadCostFanout:
    """JOINT model + cost + controller fan-out: candidates that differ
    in their SINDy regularization (`_model:threshold` / `_model:
    lasso_alpha`), their diagonal quadratic cost gains, AND share an
    iLQR horizon bucket all evaluate through ONE device program —
    per-lane STLSQ/FISTA training on the staged sysid data, then the
    per-lane-model per-lane-cost batched iLQR closed loop against the
    surrogate.

    This is the reference's flagship AutoML scenario — a fresh sysid
    model trained for every SMAC candidate, then simulated closed-loop
    (autompc/tuning/pipeline_tuner.py:213-258, pipeline.py:107-168,
    the notebook-0 "5+ hours" loop) — as a single fused batch: training
    is a vmapped masked-lstsq iteration (ops/lstsq.py:stlsq), the
    controller synthesis rides ``make_batched_ilqr_solver(
    batch_params=True, quad_cost_batch=True)`` with the per-lane-
    coefficient line-search kernel where the platform has it, and the
    whole thing shard_maps over the mesh's candidate axis.

    One instance per (SINDy basis bucket, horizon) — the shape-changing
    hyperparameters; the traced ones (reg, Q/R/F diagonals) batch
    freely.

    ``__call__(batch)`` takes ``{"reg": (B,), "Qdiag": (B, n),
    "Rdiag": (B, m), "Fdiag": (B, n)}`` and returns per-candidate task
    costs ``(B,)``.
    """

    def __init__(
        self,
        system,
        task,
        sindy_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "auto",
        reg_matrix=None,
        reg_goal=None,
    ):
        # ``backward`` as in make_batched_ilqr_solver: the platform
        # picks the kernels. ``reg_matrix``/``reg_goal``: GaussRegFactory
        # term — the batch then carries per-lane ``regw`` weights
        # (SumCost candidates; see QuadCostFanout).
        from ..core.trajectory import batch as traj_batch
        from ..ops.lstsq import fista_lasso, stlsq
        from ..sysid.sindy import SINDy

        self.system = system
        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        ubounds = (bounds[:, 0], bounds[:, 1])
        task_cost = task.get_cost()

        skeleton = SINDy(system, **sindy_cfg)
        library = skeleton.library
        time_mode = skeleton.time_mode
        method = skeleton.method
        n = system.obs_dim
        dc = system.ctrl_dim
        dt = system.dt

        # Stage the training matrices once (SINDy.train semantics,
        # sysid/sindy.py:155-185): features over the sysid split, next-
        # obs (discrete) or finite-difference (continuous) targets.
        tb = traj_batch(sysid_trajs)
        feats = library(jnp.concatenate([tb.obs, tb.ctrls], axis=-1))
        if time_mode == "continuous":
            from ..sysid.basis import finite_difference

            targets = jax.vmap(lambda o: finite_difference(o, dt))(tb.obs)
            mask = tb.mask()
        else:
            targets = jnp.roll(tb.obs, -1, axis=1)
            mask = tb.step_mask()
        A_mat = feats.reshape(-1, library.n_features)
        y_mat = targets.reshape(-1, n)
        rmask = mask.reshape(-1)
        # Normal-equations staging: all candidate lanes share the SAME
        # data matrix (only the regularizer varies), so the Gram pair
        # stages once and each lane's STLSQ is (F, F) solves instead of
        # (N, F) SVDs (tools/profile_joint_fanout.py times the phases).
        from ..ops.lstsq import gram_stage, stlsq_gram

        if method != "lasso":
            G_mat, b_mat = gram_stage(A_mat, y_mat, mask=rmask)

        def train_one(reg):
            if method == "lasso":
                coefs = fista_lasso(A_mat, y_mat, reg, mask=rmask)
            else:
                coefs = stlsq_gram(G_mat, b_mat, reg)
            return coefs.T                              # (n, F)

        def pred_core(params, state, ctrl):
            theta = library(jnp.concatenate([state, ctrl]))
            out = params["coeffs"] @ theta
            if time_mode == "continuous":
                return state + dt * out
            return out

        # The line-search kernel computes x' = coeffs @ theta directly,
        # so only discrete-time models declare a feature_spec;
        # continuous-time buckets take the XLA line search.
        feature_spec = (
            (library, "coeffs") if time_mode == "discrete" else None
        )
        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=dt, ubounds=ubounds,
            backward=backward, feature_spec=feature_spec,
            batch_params=True, quad_cost_batch=True, quad_goal=goal,
        )
        if reg_matrix is not None:
            solver_kw["reg_matrix"] = jnp.asarray(reg_matrix)
            solver_kw["reg_goal"] = (
                jnp.asarray(reg_goal) if reg_goal is not None else None
            )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                from ..control.ilqr import parse_schedule

                compact_schedule = parse_schedule(compact_schedule)
            from ..control.ilqr import make_scheduled_ilqr_solver

            solve = make_scheduled_ilqr_solver(
                pred_core, None, schedule=tuple(compact_schedule),
                **solver_kw,
            )
        else:
            from ..control.ilqr import make_batched_ilqr_solver

            solve = make_batched_ilqr_solver(pred_core, None, **solver_kw)

        surr_params = surrogate.params

        def eval_batch(batch):
            B = batch["reg"].shape[0]
            coeffs = jax.vmap(train_one)(batch["reg"])   # (B, n, F)
            params = {"coeffs": coeffs}
            cost_params = {
                "Qdiag": batch["Qdiag"],
                "Rdiag": batch["Rdiag"],
                "Fdiag": batch["Fdiag"],
            }
            if "regw" in batch:
                cost_params["regw"] = batch["regw"]
            obs0 = jnp.broadcast_to(init_obs, (B, n))

            def body(carry, _):
                obs, us_prev = carry
                if warm_start:
                    uguess = jnp.concatenate(
                        [us_prev[:, 1:], us_prev[:, -1:]], axis=1
                    )
                else:
                    uguess = jnp.zeros((B, horizon, dc))
                _, xs, us, Ks, ks = solve(params, obs, uguess, cost_params)
                u = us[:, 0] + jnp.einsum(
                    "bij,bj->bi", Ks[:, 0], obs - xs[:, 0]
                )
                next_obs = jax.vmap(
                    lambda o, uu: surrogate.pred_core(surr_params, o, uu)[:n]
                )(obs, u)
                return (
                    next_obs, us if warm_start else us_prev
                ), (obs, u)

            carry0 = (
                obs0, jnp.zeros((B, horizon if warm_start else 0, dc))
            )
            (last_obs, _), (obs_seq, ctrl_seq) = jax.lax.scan(
                body, carry0, None, length=n_steps
            )
            stage = jax.vmap(jax.vmap(task_cost.eval_obs_cost))(
                obs_seq
            ).sum(axis=0) + jax.vmap(task_cost.eval_obs_cost)(last_obs)
            ctrlc = jax.vmap(jax.vmap(task_cost.eval_ctrl_cost))(
                ctrl_seq
            ).sum(axis=0)
            term = jax.vmap(task_cost.eval_term_obs_cost)(last_obs)
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        if mesh is None:
            eval_jit = jax.jit(eval_batch)
            n_dev = 1
        else:
            from jax.sharding import PartitionSpec as P

            spec = P(mesh.axis_names[0])
            batch_keys = {"reg": 0, "Qdiag": 0, "Rdiag": 0, "Fdiag": 0}
            if reg_matrix is not None:
                batch_keys["regw"] = 0
            in_spec = jax.tree_util.tree_map(lambda _: spec, batch_keys)
            eval_jit = jax.jit(
                jax.shard_map(
                    eval_batch, mesh=mesh,
                    in_specs=(in_spec,), out_specs=spec,
                    check_vma=False,
                )
            )
            n_dev = int(np.prod(mesh.devices.shape))
        pad_quantum = n_dev * max(1, -(-8 // n_dev))

        def eval_padded(batch):
            padded, n_real = pad_to_multiple(batch, pad_quantum)
            return eval_jit(padded)[:n_real]

        self._eval = eval_padded

    def __call__(self, params_batch):
        _validate_regw(
            params_batch, getattr(self, "_has_reg", False),
            type(self).__name__,
        )
        return self._eval(params_batch)


class JointKoopmanLassoQuadCostFanout:
    """JOINT tuning fan-out for Koopman(method=lasso) pipelines: within
    a (basis configuration, horizon) bucket only the lasso alpha varies
    shapes-free, so the lifted data matrices stage once and every
    candidate trains through one vmapped FISTA solve
    (ops/lstsq.py:fista_lasso; reference usage koopman.py:150-156) into
    per-lane (A, B) operators; the closed loop then runs the
    per-lane-model per-lane-cost batched iLQR in the LIFTED state
    (ds = lifted dim; the controller state is re-lifted from the
    surrogate observation each step, Koopman.update_state_core
    semantics).

    ``__call__(batch)``: ``{"reg": (B,) lasso alphas, "Qdiag", "Rdiag",
    "Fdiag"}`` -> task costs (B,). (Koopman method=lstsq/stable buckets
    are parameter-free per basis: the tuner trains ONE model per bucket
    and rides the fixed-model QuadCostFanout instead.)
    """

    def __init__(
        self,
        system,
        task,
        koopman_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "auto",
        reg_matrix=None,
        reg_goal=None,
    ):
        from ..core.trajectory import batch as traj_batch
        from ..ops.lstsq import fista_lasso
        from ..sysid.koopman import Koopman

        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        ubounds = (bounds[:, 0], bounds[:, 1])
        task_cost = task.get_cost()
        n = system.obs_dim
        dc = system.ctrl_dim

        skeleton = Koopman(system, method="lasso", lasso_alpha=1.0,
                           **koopman_cfg)
        lift = skeleton._apply_basis
        N = skeleton.state_dim

        # Stage the lifted transition matrices once (Koopman.train
        # semantics, koopman.py:160-186).
        tb = traj_batch(sysid_trajs)
        lifted = jax.vmap(jax.vmap(lift))(tb.obs)
        m = np.asarray(tb.step_mask())
        idx_b, idx_t = np.nonzero(m)
        X = np.asarray(lifted)[idx_b, idx_t]             # (S, N)
        Y = np.asarray(lifted)[idx_b, idx_t + 1]         # (S, N)
        U = np.asarray(tb.ctrls)[idx_b, idx_t]           # (S, m)
        XU = jnp.asarray(np.concatenate([X, U], axis=1))  # (S, N+m)
        Yj = jnp.asarray(Y)

        def train_one(alpha):
            AB = fista_lasso(XU, Yj, alpha).T             # (N, N+m)
            return AB[:, :N], AB[:, N:]

        def pred_core(params, state, ctrl):
            return params["A"] @ state + params["B"] @ ctrl

        solver_kw = dict(
            H=horizon, ds=N, dc=dc, obsdim=n, dt=system.dt,
            ubounds=ubounds, backward=backward,
            batch_params=True, quad_cost_batch=True, quad_goal=goal,
        )
        if reg_matrix is not None:
            # GaussReg term over the observation embedding (first n
            # lifted dims) — obsdim=n, so the solver's reg slice lands
            # on the observations exactly as in the plain-state solver.
            solver_kw["reg_matrix"] = jnp.asarray(reg_matrix)
            solver_kw["reg_goal"] = (
                jnp.asarray(reg_goal) if reg_goal is not None else None
            )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                from ..control.ilqr import parse_schedule

                compact_schedule = parse_schedule(compact_schedule)
            from ..control.ilqr import make_scheduled_ilqr_solver

            solve = make_scheduled_ilqr_solver(
                pred_core, None, schedule=tuple(compact_schedule),
                **solver_kw,
            )
        else:
            from ..control.ilqr import make_batched_ilqr_solver

            solve = make_batched_ilqr_solver(pred_core, None, **solver_kw)

        surr_params = surrogate.params

        def eval_batch(batch):
            B = batch["reg"].shape[0]
            A_b, B_b = jax.vmap(train_one)(batch["reg"])
            params = {"A": A_b, "B": B_b}
            cost_params = {
                "Qdiag": batch["Qdiag"],
                "Rdiag": batch["Rdiag"],
                "Fdiag": batch["Fdiag"],
            }
            if "regw" in batch:
                cost_params["regw"] = batch["regw"]
            obs0 = jnp.broadcast_to(init_obs, (B, n))

            def body(carry, _):
                obs, us_prev = carry
                state = jax.vmap(lift)(obs)               # (B, N)
                if warm_start:
                    uguess = jnp.concatenate(
                        [us_prev[:, 1:], us_prev[:, -1:]], axis=1
                    )
                else:
                    uguess = jnp.zeros((B, horizon, dc))
                _, xs, us, Ks, ks = solve(
                    params, state, uguess, cost_params
                )
                u = us[:, 0]
                next_obs = jax.vmap(
                    lambda o, uu: surrogate.pred_core(surr_params, o, uu)[:n]
                )(obs, u)
                return (
                    next_obs, us if warm_start else us_prev
                ), (obs, u)

            carry0 = (
                obs0, jnp.zeros((B, horizon if warm_start else 0, dc))
            )
            (last_obs, _), (obs_seq, ctrl_seq) = jax.lax.scan(
                body, carry0, None, length=n_steps
            )
            stage = jax.vmap(jax.vmap(task_cost.eval_obs_cost))(
                obs_seq
            ).sum(axis=0) + jax.vmap(task_cost.eval_obs_cost)(last_obs)
            ctrlc = jax.vmap(jax.vmap(task_cost.eval_ctrl_cost))(
                ctrl_seq
            ).sum(axis=0)
            term = jax.vmap(task_cost.eval_term_obs_cost)(last_obs)
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        if mesh is None:
            eval_jit = jax.jit(eval_batch)
            n_dev = 1
        else:
            from jax.sharding import PartitionSpec as P

            spec = P(mesh.axis_names[0])
            eval_jit = jax.jit(
                jax.shard_map(
                    eval_batch, mesh=mesh,
                    in_specs=(spec,), out_specs=spec,
                    check_vma=False,
                )
            )
            n_dev = int(np.prod(mesh.devices.shape))
        pad_quantum = n_dev * max(1, -(-8 // n_dev))

        def eval_padded(batch):
            padded, n_real = pad_to_multiple(batch, pad_quantum)
            return eval_jit(padded)[:n_real]

        self._eval = eval_padded

    def __call__(self, params_batch):
        _validate_regw(
            params_batch, getattr(self, "_has_reg", False),
            type(self).__name__,
        )
        return self._eval(params_batch)


class JointGPQuadCostFanout:
    """JOINT tuning fan-out for ApproximateGP pipelines: candidates that
    differ in ``induce_count`` (the GP's only hyperparameter,
    largegp.py:343-348) AND diagonal cost gains evaluate in one
    per-lane-params program per horizon bucket.

    Round-3's joint_gp routing trained one shared SVGP per distinct
    induce_count in a HOST loop over buckets and ran a separate
    fixed-model fan-out per bucket — exact reference semantics but
    sequential-in-K for wide sweeps.
    Here every distinct induce_count trains in ONE batched program at a
    padded inducing count (sysid/gp.py:train_svgp_buckets — padding is
    an exact no-op, test-pinned), trained buckets are cached across
    ask() batches, and the closed loop runs the batched iLQR with
    PER-LANE GP predictor params (``batch_params=True`` + the cached
    mean-weights predictor ``gp_pred_core_cached``), so a batch mixing
    any number of induce_counts is one device program.

    ``__call__(batch)``: ``{"induce_count": (B,) ints, "Qdiag",
    "Rdiag", "Fdiag"[, "regw"]}`` -> task costs (B,).
    """

    def __init__(
        self,
        system,
        task,
        gp_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "auto",
        reg_matrix=None,
        reg_goal=None,
        pad_to: Optional[int] = None,
    ):
        from ..core.trajectory import batch as traj_batch
        from ..sysid.gp import gp_pred_core_cached

        self._has_reg = reg_matrix is not None
        self._gp_cfg = dict(gp_cfg)
        self._trajs = list(sysid_trajs)
        self.system = system
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        ubounds = (bounds[:, 0], bounds[:, 1])
        task_cost = task.get_cost()
        n = system.obs_dim
        dc = system.ctrl_dim
        n_total = int(np.asarray(traj_batch(sysid_trajs).step_mask()).sum())
        # Fixed padded inducing count = one compiled program for every
        # induce_count (the reference space tops out at 200).
        self._pad_to = int(min(pad_to or 200, n_total))
        self._bucket_cache = {}  # induce_count -> per-bucket pytree

        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=system.dt,
            ubounds=ubounds, backward=backward,
            batch_params=True, quad_cost_batch=True, quad_goal=goal,
        )
        if reg_matrix is not None:
            solver_kw["reg_matrix"] = jnp.asarray(reg_matrix)
            solver_kw["reg_goal"] = (
                jnp.asarray(reg_goal) if reg_goal is not None else None
            )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                from ..control.ilqr import parse_schedule

                compact_schedule = parse_schedule(compact_schedule)
            from ..control.ilqr import make_scheduled_ilqr_solver

            solve = make_scheduled_ilqr_solver(
                gp_pred_core_cached, None,
                schedule=tuple(compact_schedule), **solver_kw,
            )
        else:
            from ..control.ilqr import make_batched_ilqr_solver

            solve = make_batched_ilqr_solver(
                gp_pred_core_cached, None, **solver_kw
            )

        surr_params = surrogate.params

        def eval_batch(batch):
            B = batch["Qdiag"].shape[0]
            params = batch["gp_params"]
            cost_params = {
                "Qdiag": batch["Qdiag"],
                "Rdiag": batch["Rdiag"],
                "Fdiag": batch["Fdiag"],
            }
            if "regw" in batch:
                cost_params["regw"] = batch["regw"]
            obs0 = jnp.broadcast_to(init_obs, (B, n))

            def body(carry, _):
                obs, us_prev = carry
                if warm_start:
                    uguess = jnp.concatenate(
                        [us_prev[:, 1:], us_prev[:, -1:]], axis=1
                    )
                else:
                    uguess = jnp.zeros((B, horizon, dc))
                _, xs, us, Ks, ks = solve(params, obs, uguess, cost_params)
                u = us[:, 0]
                next_obs = jax.vmap(
                    lambda o, uu: surrogate.pred_core(surr_params, o, uu)[:n]
                )(obs, u)
                return (
                    next_obs, us if warm_start else us_prev
                ), (obs, u)

            carry0 = (
                obs0, jnp.zeros((B, horizon if warm_start else 0, dc))
            )
            (last_obs, _), (obs_seq, ctrl_seq) = jax.lax.scan(
                body, carry0, None, length=n_steps
            )
            stage = jax.vmap(jax.vmap(task_cost.eval_obs_cost))(
                obs_seq
            ).sum(axis=0) + jax.vmap(task_cost.eval_obs_cost)(last_obs)
            ctrlc = jax.vmap(jax.vmap(task_cost.eval_ctrl_cost))(
                ctrl_seq
            ).sum(axis=0)
            term = jax.vmap(task_cost.eval_term_obs_cost)(last_obs)
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        if mesh is None:
            eval_jit = jax.jit(eval_batch)
            n_dev = 1
        else:
            from jax.sharding import PartitionSpec as P

            spec = P(mesh.axis_names[0])
            eval_jit = jax.jit(
                jax.shard_map(
                    eval_batch, mesh=mesh,
                    in_specs=(spec,), out_specs=spec,
                    check_vma=False,
                )
            )
            n_dev = int(np.prod(mesh.devices.shape))
        pad_quantum = n_dev * max(1, -(-8 // n_dev))

        def eval_padded(batch):
            padded, n_real = pad_to_multiple(batch, pad_quantum)
            return eval_jit(padded)[:n_real]

        self._eval = eval_padded

    def _ensure_buckets(self, Ms):
        """Train every not-yet-cached distinct induce_count — one
        batched program for the whole missing set."""
        from ..sysid.gp import train_svgp_buckets

        missing = sorted({int(m) for m in Ms} - set(self._bucket_cache))
        if not missing:
            return
        params_b, w_b, norm = train_svgp_buckets(
            self.system, self._trajs, missing,
            niter=int(self._gp_cfg.get("niter", 5)),
            lr=float(self._gp_cfg.get("lr", 0.1)),
            batch_size=int(self._gp_cfg.get("batch_size", 1024)),
            seed=int(self._gp_cfg.get("seed", 100)),
            pad_to=self._pad_to,
        )
        for k, M in enumerate(missing):
            self._bucket_cache[M] = {
                "gp": jax.tree_util.tree_map(lambda a: a[k], params_b),
                "w": w_b[k],
                **norm,
            }

    def __call__(self, batch):
        _validate_regw(
            batch, getattr(self, "_has_reg", False), type(self).__name__
        )
        Ms = [int(m) for m in np.asarray(batch["induce_count"])]
        self._ensure_buckets(Ms)
        order = sorted(set(Ms))
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[self._bucket_cache[m] for m in order],
        )
        idx = jnp.asarray([order.index(m) for m in Ms])
        lane_params = jax.tree_util.tree_map(lambda a: a[idx], stacked)
        full = {
            "gp_params": lane_params,
            "Qdiag": batch["Qdiag"],
            "Rdiag": batch["Rdiag"],
            "Fdiag": batch["Fdiag"],
        }
        if "regw" in batch:
            full["regw"] = batch["regw"]
        return self._eval(full)


class JointMLPQuadCostFanout:
    """JOINT tuning fan-out for MLP-model pipelines: candidates that
    differ in hidden widths + learning rate (`_model:hidden_size_i`,
    `_model:lr`), diagonal cost gains, and share an (n_hidden_layers,
    nonlintype, horizon) bucket train as per-lane masked max-width
    nets — the WHOLE Adam run per lane, exactly the bucketed trainer's
    formulation (tuning/bucketed.py:MLPBucketEvaluator, pinned to the
    per-config ``MLP.train`` at rel 1e-5) — and then evaluate through
    the per-lane-model per-lane-cost batched iLQR closed loop
    (``make_batched_ilqr_solver(batch_params=True)``; the per-lane net
    pytree plus its masks ride the params batch axis).

    Reference scenario: a fresh torch-MLP trained per SMAC candidate
    (autompc/tuning/pipeline_tuner.py:213-258 with the default MLP
    factory, sysid/mlp.py:177-217) — the reference's single most
    expensive objective, fused here into one device program per
    candidate batch.

    ``__call__(batch)`` takes ``{"widths": ((w1, ..), ...) static
    per-candidate hidden sizes, "lr": (B,), "Qdiag": (B, n),
    "Rdiag": (B, m), "Fdiag": (B, n)}`` and returns task costs (B,).
    """

    def __init__(
        self,
        system,
        task,
        mlp_bucket: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "auto",
        reg_matrix=None,
        reg_goal=None,
        max_width: int = 256,
        n_train_iters: int = 50,
        n_batch: int = 64,
        seed: int = 100,
        horizon_mask: bool = False,
        pad_to: Optional[int] = None,
    ):
        import optax

        from ..core.trajectory import batch as traj_batch
        from ..sysid.mlp import _NONLIN

        self.system = system
        self._max_width = int(max_width)
        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        ubounds = (bounds[:, 0], bounds[:, 1])
        task_cost = task.get_cost()
        n = system.obs_dim
        dc = system.ctrl_dim
        dt = system.dt
        self._L = int(mlp_bucket["n_hidden_layers"])
        nonlintype = str(mlp_bucket["nonlintype"])
        act = _NONLIN[nonlintype]
        self._seed = int(seed)
        nxu = n + dc
        self._nxu, self._nx = nxu, n

        # Stage training pairs + z-scoring exactly as MLP.train
        # (sysid/mlp.py:158-179; same staging as MLPBucketEvaluator).
        tb = traj_batch(sysid_trajs)
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
        norm = tuple(
            jnp.asarray(v) for v in (xu_means, xu_std, dy_means, dy_std)
        )
        XUt = (jnp.asarray(XU) - norm[0]) / norm[1]
        dYt = (jnp.asarray(dY) - norm[2]) / norm[3]
        n_rows = XUt.shape[0]
        n_batch = int(n_batch)
        nb = max(n_rows // n_batch, 1)
        n_used = nb * n_batch
        n_train_iters = int(n_train_iters)

        def apply_net(net, wmasks, bmasks, x):
            for layer, wm, bm in zip(net[:-1], wmasks[:-1], bmasks[:-1]):
                x = act(x @ (layer["W"] * wm) + layer["b"] * bm)
            out, wm, bm = net[-1], wmasks[-1], bmasks[-1]
            return x @ (out["W"] * wm) + out["b"] * bm

        def train_one(params0, wmasks, bmasks, lr, key):
            gtx = optax.scale_by_adam()
            opt_state = gtx.init(params0)

            def loss_fn(p, xb, yb):
                pred = apply_net(p, wmasks, bmasks, xb)
                return jnp.mean(optax.huber_loss(pred, yb, delta=1.0))

            def epoch(carry, _):
                params, opt_state, key = carry
                key, kp = jax.random.split(key)
                perm = jax.random.permutation(kp, n_rows)[:n_used]
                xb = XUt[perm].reshape(nb, n_batch, -1)
                yb = dYt[perm].reshape(nb, n_batch, -1)

                def step(c, batch_xy):
                    params, opt_state = c
                    x, y = batch_xy
                    loss, grads = jax.value_and_grad(loss_fn)(
                        params, x, y
                    )
                    updates, opt_state = gtx.update(grads, opt_state)
                    updates = jax.tree_util.tree_map(
                        lambda u: -lr * u, updates
                    )
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                (params, opt_state), _ = jax.lax.scan(
                    step, (params, opt_state), (xb, yb)
                )
                return (params, opt_state, key), None

            (params, _, _), _ = jax.lax.scan(
                epoch, (params0, opt_state, key), None,
                length=n_train_iters,
            )
            return params

        xu_means_j, xu_std_j, dy_means_j, dy_std_j = norm

        def pred_core(params, state, ctrl):
            xu = jnp.concatenate([state, ctrl], axis=-1)
            xut = (xu - xu_means_j) / xu_std_j
            dyt = apply_net(
                params["net"], params["wmasks"], params["bmasks"], xut
            )
            return state + (dyt * dy_std_j + dy_means_j)

        from ..sysid.mlp import net_apply_jac

        def pred_diff(params, state, ctrl):
            # Closed-form layer-chain Jacobian of the masked net: fold
            # the max-width masks into the weights and reuse the shared
            # helper (sysid/mlp.py:net_apply_jac) — one implementation
            # of the chain rule, here and in MLP.pred_diff_core.
            masked_net = [
                {"W": layer["W"] * wm, "b": layer["b"] * bm}
                for layer, wm, bm in zip(
                    params["net"], params["wmasks"], params["bmasks"]
                )
            ]
            xu = jnp.concatenate([state, ctrl], axis=-1)
            xut = (xu - xu_means_j) / xu_std_j
            dyt, Jt = net_apply_jac(masked_net, xut, nonlintype)
            Jm = (dy_std_j[:, None] * Jt) / xu_std_j[None, :]
            pred = state + (dyt * dy_std_j + dy_means_j)
            Jx = jnp.eye(n, dtype=Jm.dtype) + Jm[:, :n]
            return pred, Jx, Jm[:, n:]

        # horizon_mask: ``horizon`` is H_MAX and candidates carry their
        # own effective horizon (batch["horizons"]) — ONE compiled
        # program per (n_hidden_layers, nonlintype) bucket instead of
        # one per distinct horizon hyperparameter value
        # (control/ilqr.py horizon_mask; pinned exact in
        # tests/test_horizon_mask.py).
        self._horizon_mask = bool(horizon_mask)
        # pad_to: fixed minimum lane count — small tuner buckets stop
        # compiling one program per distinct padded size (size joins
        # horizon as a removed compile axis; padded lanes replicate
        # the last candidate and cost only device compute).
        self._pad_to = int(pad_to) if pad_to else None
        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=dt, ubounds=ubounds,
            backward=backward,
            batch_params=True, quad_cost_batch=True, quad_goal=goal,
            pred_diff=pred_diff, horizon_mask=self._horizon_mask,
        )
        if reg_matrix is not None:
            solver_kw["reg_matrix"] = jnp.asarray(reg_matrix)
            solver_kw["reg_goal"] = (
                jnp.asarray(reg_goal) if reg_goal is not None else None
            )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                from ..control.ilqr import parse_schedule

                compact_schedule = parse_schedule(compact_schedule)
            from ..control.ilqr import make_scheduled_ilqr_solver

            solve = make_scheduled_ilqr_solver(
                pred_core, None, schedule=tuple(compact_schedule),
                **solver_kw,
            )
        else:
            from ..control.ilqr import make_batched_ilqr_solver

            solve = make_batched_ilqr_solver(pred_core, None, **solver_kw)

        surr_params = surrogate.params

        def train_batch(batch):
            key = jax.random.PRNGKey(self._seed)
            key, _ = jax.random.split(key)  # mirrors MLPBucketEvaluator
            return jax.vmap(
                train_one, in_axes=(0, 0, 0, 0, None)
            )(batch["net0"], batch["wmasks"], batch["bmasks"],
              batch["lr"], key)

        # Phase-profile hook (tools/profile_mlp_fanout.py): training
        # alone, single-device.
        self._train_jit = jax.jit(train_batch)

        def eval_batch(batch):
            B = batch["lr"].shape[0]
            nets = train_batch(batch)
            params = {
                "net": nets,
                "wmasks": batch["wmasks"],
                "bmasks": batch["bmasks"],
            }
            cost_params = {
                "Qdiag": batch["Qdiag"],
                "Rdiag": batch["Rdiag"],
                "Fdiag": batch["Fdiag"],
            }
            if "regw" in batch:
                cost_params["regw"] = batch["regw"]
            if self._horizon_mask:
                cost_params["heff"] = batch["horizons"].astype(jnp.int32)
            obs0 = jnp.broadcast_to(init_obs, (B, n))

            def body(carry, _):
                obs, us_prev = carry
                if warm_start:
                    uguess = jnp.concatenate(
                        [us_prev[:, 1:], us_prev[:, -1:]], axis=1
                    )
                else:
                    uguess = jnp.zeros((B, horizon, dc))
                _, xs, us, Ks, ks = solve(params, obs, uguess, cost_params)
                u = us[:, 0]
                next_obs = jax.vmap(
                    lambda o, uu: surrogate.pred_core(surr_params, o, uu)[:n]
                )(obs, u)
                return (
                    next_obs, us if warm_start else us_prev
                ), (obs, u)

            carry0 = (
                obs0, jnp.zeros((B, horizon if warm_start else 0, dc))
            )
            (last_obs, _), (obs_seq, ctrl_seq) = jax.lax.scan(
                body, carry0, None, length=n_steps
            )
            stage = jax.vmap(jax.vmap(task_cost.eval_obs_cost))(
                obs_seq
            ).sum(axis=0) + jax.vmap(task_cost.eval_obs_cost)(last_obs)
            ctrlc = jax.vmap(jax.vmap(task_cost.eval_ctrl_cost))(
                ctrl_seq
            ).sum(axis=0)
            term = jax.vmap(task_cost.eval_term_obs_cost)(last_obs)
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        if mesh is None:
            self._eval_jit = jax.jit(eval_batch)
            n_dev = 1
        else:
            from jax.sharding import PartitionSpec as P

            spec = P(mesh.axis_names[0])
            # Single-spec prefix: every leaf of the batch dict shards
            # over the candidate axis.
            self._eval_jit = jax.jit(
                jax.shard_map(
                    eval_batch, mesh=mesh,
                    in_specs=(spec,),
                    out_specs=spec,
                    check_vma=False,
                )
            )
            n_dev = int(np.prod(mesh.devices.shape))
        self._pad_quantum = n_dev * max(1, -(-8 // n_dev))

    def _prepare(self, batch):
        """Stage a candidate batch: padded per-lane init nets + masks
        from the static widths, lane arrays padded to the shard
        quantum. Returns (full_batch_dict, n_real)."""
        _validate_regw(
            batch, getattr(self, "_has_reg", False), type(self).__name__
        )
        from ..tuning.bucketed import _mlp_masks, _mlp_padded_init

        widths_list = [list(w) for w in batch["widths"]]
        B = len(widths_list)
        q = self._pad_quantum
        target = ((B + q - 1) // q) * q
        if self._pad_to is not None:
            target = max(target, ((self._pad_to + q - 1) // q) * q)
        widths_list += [widths_list[-1]] * (target - B)

        key = jax.random.PRNGKey(self._seed)
        _, k_init = jax.random.split(key)
        net0, wmasks, bmasks = [], [], []
        for widths in widths_list:
            net0.append(_mlp_padded_init(
                k_init, self._nxu, self._nx, widths, self._max_width
            ))
            wm, bm = _mlp_masks(
                self._nxu, self._nx, widths, self._max_width
            )
            wmasks.append([jnp.asarray(m) for m in wm])
            bmasks.append([jnp.asarray(m) for m in bm])
        stack = lambda seqs: jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *seqs
        )

        def pad(a):
            a = jnp.asarray(a)
            return jnp.concatenate(
                [a] + [a[-1:]] * (target - B), axis=0
            ) if target > B else a

        full = {
            "net0": stack(net0),
            "wmasks": stack(wmasks),
            "bmasks": stack(bmasks),
            "lr": pad(batch["lr"]),
            "Qdiag": pad(batch["Qdiag"]),
            "Rdiag": pad(batch["Rdiag"]),
            "Fdiag": pad(batch["Fdiag"]),
        }
        if "regw" in batch:
            full["regw"] = pad(batch["regw"])
        if self._horizon_mask:
            full["horizons"] = pad(
                jnp.asarray(batch["horizons"], jnp.int32)
            )
        return full, B

    def __call__(self, batch):
        full, B = self._prepare(batch)
        return self._eval_jit(full)[:B]

    def _train_only(self, batch):
        """Per-lane training alone (no closed loop) — the phase-profile
        hook for tools/profile_mlp_fanout.py."""
        full, _ = self._prepare(batch)
        return self._train_jit(full)


class DirectTranscriptionFanout:
    """Evaluate a batch of diagonal quadratic-cost candidates with a
    direct-transcription (SQP) controller synthesized per candidate
    (control/nmpc.py semantics). ``horizon_knots`` is the knot count (the
    factory's horizon hyperparameter is seconds; knots =
    ceil(horizon / dt), reference nmpc.py:254) — one fan-out per knot
    bucket."""

    def __init__(
        self,
        system,
        task,
        model,
        surrogate,
        horizon_knots: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        reg_matrix=None,
        reg_goal=None,
    ):
        # ``reg_matrix``/``reg_goal``: GaussRegFactory term, as a
        # per-lane SumCost through the generic SQP cost path (see
        # MPPIFanout).
        from ..control.nmpc import make_sqp_solver

        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task.get_cost().get_goal() if task.get_cost() is not None
                  else jnp.zeros(system.obs_dim))
        )
        init_obs = jnp.asarray(task.get_init_obs())
        bounds = task.get_ctrl_bounds()
        finite_lo = np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -1e9)
        finite_hi = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1e9)
        task_cost = task.get_cost()

        model_params = model.params
        surr_params = surrogate.params
        H = int(horizon_knots)
        ds = model.state_dim
        dc = system.ctrl_dim
        n = system.obs_dim
        from ..core.trajectory import zeros as traj_zeros

        seed_traj = traj_zeros(system, 1).set_obs(0, init_obs)
        mstate0 = model.traj_to_state(seed_traj)

        if reg_matrix is not None:
            Sreg = jnp.asarray(reg_matrix)
            mureg = (
                jnp.asarray(reg_goal) if reg_goal is not None
                else jnp.zeros(n)
            )

        def eval_one(cost_params):
            cost = QuadCost(
                system,
                jnp.diag(cost_params["Qdiag"]),
                jnp.diag(cost_params["Rdiag"]),
                jnp.diag(cost_params["Fdiag"]),
                goal=goal,
            )
            if reg_matrix is not None:
                cost = cost + QuadCost(
                    system,
                    cost_params["regw"] * Sreg,
                    jnp.zeros((dc, dc)),
                    jnp.zeros((n, n)),
                    goal=mureg,
                )
            solve = make_sqp_solver(
                model.pred_core, cost,
                H=H, ds=ds, dc=dc, obsdim=n,
                dt=system.dt, ubounds=(finite_lo, finite_hi),
                # Observation box constraints, as in the standalone
                # controller (DirectTranscriptionController; reference
                # IPOPT variable bounds, nmpc.py:121-130).
                xbounds=(
                    (task.get_obs_bounds()[:, 0],
                     task.get_obs_bounds()[:, 1])
                    if task.are_obs_bounded() else None
                ),
            )

            def ctrl_step(cstate, obs):
                mstate, last_u, xs_guess, us_guess = cstate
                state = model.update_state_core(
                    model_params, mstate, last_u, obs
                )
                xs, us = solve(model_params, state, xs_guess, us_guess)
                u = us[0]
                # Warm start the next MPC step (nmpc.py:319-320).
                return u, (state, u, xs, us)

            def advance(obs, u):
                return surrogate.pred_core(surr_params, obs, u)[:n]

            cstate0 = (
                mstate0, jnp.zeros(dc), jnp.zeros((H + 1, ds)),
                jnp.zeros((H, dc)),
            )
            all_obs, ctrl_seq, _ = rollout_scan(
                ctrl_step, advance, cstate0, init_obs, n_steps
            )
            stage = jax.vmap(task_cost.eval_obs_cost)(all_obs).sum()
            ctrlc = jax.vmap(task_cost.eval_ctrl_cost)(ctrl_seq).sum()
            term = task_cost.eval_term_obs_cost(all_obs[-1])
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        self._eval = shard_vmap(eval_one, mesh=mesh)

    def __call__(self, params_batch):
        _validate_regw(
            params_batch, getattr(self, "_has_reg", False),
            type(self).__name__,
        )
        return self._eval(params_batch)


class MPPIFanout:
    """Evaluate batches of MPPI solver configurations (sigma, lmda) +
    quad-cost gains against a surrogate — all scalars, so one compiled
    program covers the whole (num_path, horizon) bucket."""

    def __init__(
        self,
        system,
        task,
        model,
        surrogate,
        horizon: int = 20,
        num_path: int = 512,
        n_steps: Optional[int] = None,
        mesh=None,
        seed: int = 0,
        goal=None,
        reg_matrix=None,
        reg_goal=None,
    ):
        # ``reg_matrix``/``reg_goal``: GaussRegFactory term — each
        # lane's cost becomes the SumCost ``diag-quad + regw * full``
        # (built from traced values inside the vmap; MPPI consumes the
        # cost generically, so no solver change is needed).
        from ..control.mppi import MPPI

        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        init_obs = jnp.asarray(task.get_init_obs())
        task_cost = task.get_cost()
        goal = jnp.asarray(
            goal
            if goal is not None
            else (task_cost.get_goal()
                  if task_cost is not None and task_cost.has_goal
                  else jnp.zeros(system.obs_dim))
        )
        n = system.obs_dim
        surr_params = surrogate.params
        from ..core.trajectory import zeros as traj_zeros

        seed_traj = traj_zeros(system, 1).set_obs(0, init_obs)
        mstate0 = model.traj_to_state(seed_traj)

        if reg_matrix is not None:
            Sreg = jnp.asarray(reg_matrix)
            mureg = (
                jnp.asarray(reg_goal) if reg_goal is not None
                else jnp.zeros(n)
            )

        def eval_one(cfg):
            cost = QuadCost(
                system,
                jnp.diag(cfg["Qdiag"]),
                jnp.diag(cfg["Rdiag"]),
                jnp.diag(cfg["Fdiag"]),
                goal=goal,
            )
            if reg_matrix is not None:
                cost = cost + QuadCost(
                    system,
                    cfg["regw"] * Sreg,
                    jnp.zeros((system.ctrl_dim, system.ctrl_dim)),
                    jnp.zeros((n, n)),
                    goal=mureg,
                )
            task_local = task.copy()
            task_local.set_cost(cost)
            con = MPPI(
                system, task_local, model,
                horizon=horizon, num_path=num_path, seed=seed,
            )
            # Override the static sigma/lmda with traced values.
            con.sigma = cfg["sigma"]
            con.lmda = cfg["lmda"]

            key = jax.random.PRNGKey(seed)
            key, k0 = jax.random.split(key)
            act0 = jnp.sqrt(cfg["sigma"]) * jax.random.normal(
                k0, (horizon, system.ctrl_dim)
            )
            cstate0 = dict(
                model_state=mstate0,
                last_u=jnp.zeros(system.ctrl_dim),
                act_sequence=act0,
                key=key,
            )

            def advance(obs, u):
                return surrogate.pred_core(surr_params, obs, u)[:n]

            all_obs, ctrl_seq, _ = rollout_scan(
                con.step, advance, cstate0, init_obs, n_steps
            )
            stage = jax.vmap(task_cost.eval_obs_cost)(all_obs).sum()
            ctrlc = jax.vmap(task_cost.eval_ctrl_cost)(ctrl_seq).sum()
            term = task_cost.eval_term_obs_cost(all_obs[-1])
            total = stage + ctrlc + term
            return jnp.where(jnp.isfinite(total), total, jnp.inf)

        self._eval = shard_vmap(eval_one, mesh=mesh)

    def __call__(self, params_batch):
        _validate_regw(
            params_batch, getattr(self, "_has_reg", False),
            type(self).__name__,
        )
        return self._eval(params_batch)
