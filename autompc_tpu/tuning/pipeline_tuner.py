"""Pipeline tuner: joint AutoML over {model, cost, controller}.

Re-creates the reference PipelineTuner (reference:
autompc/tuning/pipeline_tuner.py:78-319): split the data into surrogate
and system-ID sets, build a surrogate dynamics model (five modes), then
optimize the pipeline's joint configuration space where each candidate
is instantiated and **simulated closed-loop against the surrogate**; the
surrogate trajectory's task cost is the tuning objective. Optionally the
true dynamics cost is recorded per iteration (reporting only).

Differences from the reference: the optimizer is batched BO
(tuning/bo.py), each candidate's closed-loop rollout runs as one fused
scan on device, and
batches of candidates can be evaluated through the parallel fan-out in
``autompc_tpu.parallel`` (config-level data parallelism over a mesh).
Exceptions and non-finite rollouts score ``inf`` and tuning continues
(pipeline_tuner.py:236-239 contract).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..evaluation import HoldoutModelEvaluator
from ..utils.simulation import simulate
from .bo import BatchBayesOpt
from .model_tuner import ModelTuner

PipelineTuneResult = namedtuple(
    "PipelineTuneResult",
    [
        "inc_cfg", "cfgs", "inc_cfgs", "costs", "inc_costs",
        "truedyn_costs", "inc_truedyn_costs", "surr_trajs",
        "truedyn_trajs", "surr_tune_result",
    ],
)
"""Tuning history (pipeline_tuner.py:19-77 semantics)."""


def _cost_fanout_spec(cost_factory):
    """Which cost-factory layouts the per-lane-cost solver covers, and
    where their hyperparameters live in the joint config.

    Returns ``None`` (unsupported) or a dict:

    - ``quad_prefix``: config-name prefix of the QuadCostFactory
      subspace under ``_cost:`` ("" for a bare QuadCostFactory,
      ``"_sum_i:"`` inside a SumCostFactory, ``None`` if absent —
      diagonals are then zero);
    - ``quad_factory``: that factory instance (for its ``goal``), or
      None;
    - ``reg_prefix``: prefix of the GaussRegFactory subspace, or None.

    Covered layouts: QuadCostFactory; GaussRegFactory; SumCostFactory
    of at most one of each (reference's documented combination,
    autompc/costs/gauss_reg_factory.py:17-19 "typically used in
    combination with another cost"). The per-lane solver cost is then
    ``diag-quad(task/factory goal) + regw * (x-mu)' Sigma_x^-1 (x-mu)``
    (make_batched_ilqr_solver's reg term).
    """
    from ..costs.gauss_reg_factory import GaussRegFactory
    from ..costs.quad_cost_factory import QuadCostFactory
    from ..costs.sum_cost_factory import SumCostFactory

    if isinstance(cost_factory, QuadCostFactory):
        return {
            "quad_prefix": "", "quad_factory": cost_factory,
            "reg_prefix": None,
        }
    if isinstance(cost_factory, GaussRegFactory):
        return {"quad_prefix": None, "quad_factory": None, "reg_prefix": ""}
    if isinstance(cost_factory, SumCostFactory):
        quad = None
        reg = None
        for i, f in enumerate(cost_factory.factories):
            if isinstance(f, QuadCostFactory) and quad is None:
                quad = (i, f)
            elif isinstance(f, GaussRegFactory) and reg is None:
                reg = i
            else:
                return None
        return {
            "quad_prefix": f"_sum_{quad[0]}:" if quad else None,
            "quad_factory": quad[1] if quad else None,
            "reg_prefix": f"_sum_{reg}:" if reg is not None else None,
        }
    return None


def _gauss_reg_stats(sysid_trajs):
    """(Sigma_x^-1, mu_x) over the sysid split — exactly
    GaussRegFactory.__call__'s statistics (costs/gauss_reg_factory.py;
    reference autompc/costs/gauss_reg_factory.py:38-41)."""
    from ..core.trajectory import batch as traj_batch

    tb = traj_batch(sysid_trajs)
    mask = np.asarray(tb.mask())
    X = np.asarray(tb.obs)[mask]
    mean = np.mean(X, axis=0)
    cov = np.atleast_2d(np.cov(X, rowvar=False))
    return np.linalg.inv(cov), mean


def _autoselect_factories():
    from ..sysid import (
        ARXFactory,
        ApproximateGPModelFactory,
        KoopmanFactory,
        MLPFactory,
        SINDyFactory,
    )

    return [MLPFactory, SINDyFactory, ApproximateGPModelFactory, ARXFactory,
            KoopmanFactory]


class PipelineTuner:
    """Tunes SysID+MPC pipelines."""

    def __init__(
        self,
        surrogate_mode="defaultcfg",
        surrogate_factory=None,
        surrogate_split=None,
        surrogate_cfg=None,
        surrogate_evaluator=None,
        surrogate_tune_holdout=0.25,
        surrogate_tune_metric="rmse",
        eval_batch: int = 4,
        use_fanout: bool = False,
        mesh=None,
        fanout_compact=None,
        fanout_warm_start: bool = False,
        fanout_horizon_mask: bool = True,
    ):
        """``surrogate_mode``: one of "defaultcfg", "fixedcfg",
        "autotune", "autoselect", "pretrain"
        (pipeline_tuner.py:116-149). "pretrain" uses an
        already-trained surrogate passed via ``run(surrogate=...)``;
        every other mode trains one from the surrogate split.

        ``use_fanout=True`` enables the mesh-parallel fast path: when
        the cost factory is QuadCostFactory / GaussRegFactory / their
        SumCostFactory combination (``_cost_fanout_spec``) and the
        controller factory is one of IterativeLQRFactory / MPPIFactory
        / DirectTranscriptionControllerFactory, each ask() batch is
        bucketed by its
        shape-changing hyperparameters (horizon; num_path for MPPI) and
        every bucket is evaluated as ONE sharded program
        (parallel/fanout.py) — candidate synthesis + closed-loop
        surrogate rollout + metric, all on device. Joint (model-
        factory) pipelines fan out too: SINDy/ARX/MLP/Koopman model
        factories train per-candidate models inside the batch.
        Per-candidate surrogate trajectories are not recorded on this
        path.

        ``fanout_compact``: optional converged-lane compaction schedule
        ``((cut_iter, size_frac), ...)`` for the iLQR fan-out's
        per-step solve (make_scheduled_ilqr_solver); worthwhile for
        large ``eval_batch`` (measured 3.3x at 512 candidates/chip).

        ``fanout_warm_start=True`` warm-starts each closed-loop step's
        iLQR solve from the previous step's shifted solution instead of
        the reference's zero guess (a beyond-parity option: ~1.6x more
        evals/s, and the evaluated controller is the warm-started MPC).

        ``fanout_horizon_mask`` (default True): horizon-POLYMORPHIC
        joint-MLP fan-outs — the controller's horizon hyperparameter
        stops being a bucket key; one program compiles at the config
        space's H upper bound and every lane carries its effective
        horizon (control/ilqr.py horizon_mask, algebraically exact —
        tests/test_horizon_mask.py). Without it, a 100-candidate tune
        whose horizons rarely repeat compiles ~one program per
        candidate, and compilation then dominates the tune.
        """
        self.surrogate_mode = surrogate_mode
        self.surrogate_factory = surrogate_factory
        self.surrogate_split = surrogate_split
        self.surrogate_cfg = surrogate_cfg
        self.surrogate_evaluator = surrogate_evaluator
        self.surrogate_tune_holdout = surrogate_tune_holdout
        self.surrogate_tune_metric = surrogate_tune_metric
        self.eval_batch = int(eval_batch)
        self.use_fanout = bool(use_fanout)
        self.mesh = mesh
        self.fanout_compact = fanout_compact
        self.fanout_warm_start = bool(fanout_warm_start)
        self.fanout_horizon_mask = bool(fanout_horizon_mask)

    def _fanout_kind(self, pipeline, surrogate):
        """Which fan-out fast path (if any) covers this pipeline.

        Returns ``(kind, reason)`` — ``kind`` one of:

        - ``"ilqr"`` / ``"mppi"`` / ``"dt"``: fixed (pre-trained) model,
          QuadCostFactory, matching controller factory;
        - ``"joint_sindy"``: JOINT tuning — SINDyFactory model (a fresh
          model trained per candidate, the reference's flagship
          scenario) + QuadCostFactory + IterativeLQRFactory, fused as
          per-lane training + per-lane-model solves
          (parallel/fanout.py:JointSINDyQuadCostFanout);
        - ``"joint_arx"``: ARXFactory model — the only model
          hyperparameter (history) is shape-changing, so each history
          bucket trains ONE shared model and rides the fixed-model
          QuadCostFanout;
        - ``None``: no fast path; ``reason`` says why (the tuner warns
          when ``use_fanout=True`` falls back — the fallback used to be
          silent).

        Cost factories covered: QuadCostFactory, GaussRegFactory, and
        SumCostFactory of at most one of each (``_cost_fanout_spec``) —
        the GaussReg term rides the batched iLQR solver's
        per-lane-weighted shared dense quadratic, and the MPPI/DT
        fan-outs build it as a per-lane SumCost. Anything else falls
        back to the sequential objective with a warning. All paths
        require an obs-state surrogate.
        """
        from ..control.ilqr import IterativeLQRFactory
        from ..control.mppi import MPPIFactory
        from ..control.nmpc import DirectTranscriptionControllerFactory
        from ..sysid.arx import ARXFactory
        from ..sysid.sindy import SINDyFactory

        if not self.use_fanout:
            return None, "use_fanout=False"
        cost_spec = _cost_fanout_spec(pipeline.cost_factory)
        if cost_spec is None:
            return None, (
                "cost factory is "
                f"{type(pipeline.cost_factory).__name__}; the per-lane "
                "solver covers QuadCostFactory / GaussRegFactory / "
                "their SumCostFactory combination only"
            )
        if surrogate.state_dim != pipeline.system.obs_dim:
            return None, (
                "surrogate has lifted state "
                f"(state_dim={surrogate.state_dim} != obs_dim="
                f"{pipeline.system.obs_dim}); the fan-out closed loop "
                "advances observation-state surrogates only"
            )
        cf = pipeline.controller_factory
        if pipeline.model is not None:
            if isinstance(cf, IterativeLQRFactory):
                return "ilqr", ""
            if isinstance(cf, MPPIFactory):
                return "mppi", ""
            if isinstance(cf, DirectTranscriptionControllerFactory):
                return "dt", ""
            return None, (
                f"controller factory {type(cf).__name__} has no fan-out "
                "implementation"
            )
        if isinstance(pipeline.model_factory, SINDyFactory):
            if isinstance(cf, IterativeLQRFactory):
                return "joint_sindy", ""
            return None, (
                "joint SINDy fan-out supports IterativeLQRFactory; got "
                f"{type(cf).__name__}"
            )
        if isinstance(pipeline.model_factory, ARXFactory):
            if isinstance(cf, IterativeLQRFactory):
                return "joint_arx", ""
            return None, (
                "joint ARX fan-out supports IterativeLQRFactory; got "
                f"{type(cf).__name__}"
            )
        from ..sysid.mlp import MLPFactory

        if isinstance(pipeline.model_factory, MLPFactory):
            if isinstance(cf, IterativeLQRFactory):
                return "joint_mlp", ""
            return None, (
                "joint MLP fan-out supports IterativeLQRFactory; got "
                f"{type(cf).__name__}"
            )
        from ..sysid.koopman import KoopmanFactory

        if isinstance(pipeline.model_factory, KoopmanFactory):
            if isinstance(cf, IterativeLQRFactory):
                return "joint_koopman", ""
            return None, (
                "joint Koopman fan-out supports IterativeLQRFactory; "
                f"got {type(cf).__name__}"
            )
        from ..sysid.gp import ApproximateGPModelFactory

        if isinstance(pipeline.model_factory, ApproximateGPModelFactory):
            # Like ARX: the GP's only hyperparameter (induce_count) is
            # shape-changing, so each bucket trains ONE shared SVGP —
            # exactly what the reference's per-candidate training would
            # produce (same data, same seed) — and rides the
            # fixed-model QuadCostFanout with the cached-mean-weights
            # predictor (sysid/gp.py:params "w").
            if isinstance(cf, IterativeLQRFactory):
                return "joint_gp", ""
            return None, (
                "joint GP fan-out supports IterativeLQRFactory; got "
                f"{type(cf).__name__}"
            )
        return None, (
            "joint fan-out covers SINDy/ARX/MLP/Koopman/ApproximateGP "
            f"model factories; got {type(pipeline.model_factory).__name__}"
        )

    def _eval_batch_fanout(self, pipeline, task, surrogate, cfgs, fanouts,
                           kind, sysid_trajs=None):
        """Evaluate a batch of configurations through shape-bucketed
        sharded fan-outs (one compiled program per bucket of
        shape-changing hyperparameters). Returns costs aligned with
        cfgs. ``sysid_trajs`` feeds the joint kinds' on-device model
        training."""
        import jax.numpy as jnp
        import numpy as np

        from ..parallel.fanout import (
            DirectTranscriptionFanout,
            JointSINDyQuadCostFanout,
            MPPIFanout,
            QuadCostFanout,
        )

        system = pipeline.system
        n_steps = (task.get_num_steps() or 200) - 1
        cost_spec = _cost_fanout_spec(pipeline.cost_factory)
        qp = cost_spec["quad_prefix"]
        rp = cost_spec["reg_prefix"]
        # Goal resolution mirrors QuadCostFactory.__call__
        # (costs/quad_cost_factory.py): factory goal wins over task goal.
        factory_goal = getattr(cost_spec["quad_factory"], "goal", None)
        if factory_goal is not None:
            goal = np.nan_to_num(np.asarray(factory_goal, dtype=float))
        elif task.get_cost() is not None and task.get_cost().has_goal:
            goal = np.nan_to_num(
                np.asarray(task.get_cost().get_goal(), dtype=float)
            )
        else:
            goal = np.zeros(system.obs_dim)
        reg_kw = {}
        if rp is not None:
            # GaussReg statistics over the sysid split, computed once
            # per tuner run (GaussRegFactory.__call__ semantics).
            if getattr(self, "_reg_stats", None) is None:
                self._reg_stats = _gauss_reg_stats(sysid_trajs)
            Sreg, mureg = self._reg_stats
            reg_kw = dict(reg_matrix=Sreg, reg_goal=mureg)

        # Controller kwargs resolve like ControllerFactory.__call__:
        # factory constructor kwargs override configuration values.
        overrides = getattr(pipeline.controller_factory, "kwargs", {})

        def ck(cfg, name, default):
            if name in overrides:
                return overrides[name]
            return cfg.get(f"_ctrlr:{name}", default)

        # Model-factory hyperparameters resolve the same way
        # (ModelFactory.__call__: constructor kwargs override cfg).
        m_over = getattr(pipeline.model_factory, "kwargs", None) or {}

        def mk(cfg, name, default):
            if name in m_over:
                return m_over[name]
            return cfg.get(f"_model:{name}", default)

        def sindy_bucket(cfg):
            """Shape/trace bucket of a SINDy candidate: the basis-
            library configuration (one compiled program per bucket;
            the regularization scalar is traced per lane)."""
            return dict(
                method=str(mk(cfg, "method", "lstsq")),
                time_mode=str(mk(cfg, "time_mode", "discrete")),
                poly_basis=mk(cfg, "poly_basis", "false"),
                poly_degree=int(mk(cfg, "poly_degree", 3)),
                poly_cross_terms=mk(cfg, "poly_cross_terms", "false"),
                trig_basis=mk(cfg, "trig_basis", "false"),
                trig_freq=int(mk(cfg, "trig_freq", 1)),
                trig_interaction=mk(cfg, "trig_interaction", "false"),
            )

        # Horizon-polymorphic joint-MLP buckets (fanout_horizon_mask):
        # one program at the config space's horizon UPPER BOUND serves
        # every candidate horizon — the horizon stops multiplying
        # compiled programs (control/ilqr.py horizon_mask doc).
        hmask_on = self.fanout_horizon_mask and kind == "joint_mlp"
        h_upper = None
        if hmask_on:
            try:
                cs_c = (
                    pipeline.controller_factory.get_configuration_space()
                )
                h_upper = int(cs_c.get_hyperparameter("horizon").upper)
            except Exception:
                h_upper = None
            if "horizon" in overrides:
                # A factory-pinned horizon is a single bucket anyway.
                hmask_on = False
        if hmask_on and h_upper is None:
            hmask_on = False

        # Bucket by the shape-changing hyperparameters.
        buckets = {}
        for idx, cfg in enumerate(cfgs):
            horizon = ck(cfg, "horizon", 20)
            if kind == "mppi":
                key = (int(horizon), int(ck(cfg, "num_path", 200)))
            elif kind == "dt":
                # Factory horizon is seconds; knots = ceil(h/dt)
                # (nmpc.py:254).
                key = int(np.ceil(horizon / system.dt))
            elif kind == "joint_sindy":
                key = (
                    tuple(sorted(sindy_bucket(cfg).items())), int(horizon)
                )
            elif kind == "joint_mlp":
                key = (
                    int(mk(cfg, "n_hidden_layers", "2")),
                    str(mk(cfg, "nonlintype", "relu")),
                    h_upper if hmask_on else int(horizon),
                )
            elif kind == "joint_koopman":
                kb = dict(
                    poly_basis=mk(cfg, "poly_basis", "false"),
                    poly_degree=int(mk(cfg, "poly_degree", 3)),
                    trig_basis=mk(cfg, "trig_basis", "false"),
                    trig_freq=int(mk(cfg, "trig_freq", 1)),
                    product_terms=mk(cfg, "product_terms", "false"),
                )
                key = (
                    str(mk(cfg, "method", "lstsq")),
                    tuple(sorted(kb.items())),
                    int(horizon),
                )
            elif kind == "joint_arx":
                key = (int(mk(cfg, "history", 4)), int(horizon))
            elif kind == "joint_gp":
                # induce_count no longer buckets: every distinct value
                # trains in ONE batched padded program and the closed
                # loop carries per-lane GP params
                # (parallel/fanout.py:JointGPQuadCostFanout).
                key = int(horizon)
            else:
                key = int(horizon)
            buckets.setdefault(key, []).append(idx)

        costs = [None] * len(cfgs)
        for key, idxs in buckets.items():
            if key not in fanouts:
                common = dict(n_steps=n_steps, mesh=self.mesh, goal=goal)
                if kind == "ilqr":
                    # A discrete-time SINDy model is linear in its
                    # features; declaring it lets the platform pick the
                    # line-search kernel (control/ilqr.py).
                    fs = None
                    if (
                        getattr(pipeline.model, "time_mode", None)
                        == "discrete"
                        and hasattr(pipeline.model, "library")
                    ):
                        fs = (pipeline.model.library, "coeffs")
                    fanouts[key] = QuadCostFanout(
                        system, task, pipeline.model, surrogate,
                        horizon=key,
                        compact_schedule=self.fanout_compact,
                        warm_start=self.fanout_warm_start,
                        feature_spec=fs,
                        **reg_kw,
                        **common,
                    )
                elif kind == "mppi":
                    fanouts[key] = MPPIFanout(
                        system, task, pipeline.model, surrogate,
                        horizon=key[0], num_path=key[1], **reg_kw,
                        **common,
                    )
                elif kind == "joint_sindy":
                    fanouts[key] = JointSINDyQuadCostFanout(
                        system, task, dict(key[0]), sysid_trajs,
                        surrogate, horizon=key[1],
                        compact_schedule=self.fanout_compact,
                        warm_start=self.fanout_warm_start,
                        **reg_kw,
                        **common,
                    )
                elif kind == "joint_mlp":
                    from ..parallel.fanout import JointMLPQuadCostFanout

                    fanouts[key] = JointMLPQuadCostFanout(
                        system, task,
                        dict(
                            n_hidden_layers=key[0], nonlintype=key[1]
                        ),
                        sysid_trajs, surrogate, horizon=key[2],
                        horizon_mask=hmask_on,
                        # With horizon-polymorphic buckets also pin the
                        # padded lane count: at most ONE compiled
                        # program per (n_layers, nonlintype) bucket.
                        pad_to=self.eval_batch if hmask_on else None,
                        compact_schedule=self.fanout_compact,
                        warm_start=self.fanout_warm_start,
                        **reg_kw,
                        n_train_iters=int(
                            m_over.get("n_train_iters", 50)
                        ),
                        n_batch=int(m_over.get("n_batch", 64)),
                        seed=int(m_over.get("seed", 100)),
                        **common,
                    )
                elif kind == "joint_koopman":
                    method = key[0]
                    if method == "lasso":
                        from ..parallel.fanout import (
                            JointKoopmanLassoQuadCostFanout,
                        )

                        fanouts[key] = JointKoopmanLassoQuadCostFanout(
                            system, task, dict(key[1]), sysid_trajs,
                            surrogate, horizon=key[2],
                            compact_schedule=self.fanout_compact,
                            warm_start=self.fanout_warm_start,
                            **reg_kw,
                            **common,
                        )
                    else:
                        # lstsq/stable are parameter-free per basis
                        # bucket: one shared model, fixed-model fan-out.
                        from ..sysid.koopman import Koopman

                        km = Koopman(system, method=method, **dict(key[1]))
                        km.train(sysid_trajs)
                        fanouts[key] = QuadCostFanout(
                            system, task, km, surrogate,
                            horizon=key[2],
                            compact_schedule=self.fanout_compact,
                            warm_start=self.fanout_warm_start,
                            **reg_kw,
                            **common,
                        )
                elif kind == "joint_arx":
                    # One shared model per history bucket (the only ARX
                    # hyperparameter IS the bucket key), then the
                    # fixed-model fan-out.
                    from ..sysid.arx import ARX

                    arx = ARX(system, history=key[0])
                    arx.train(sysid_trajs)
                    fanouts[key] = QuadCostFanout(
                        system, task, arx, surrogate,
                        horizon=key[1],
                        compact_schedule=self.fanout_compact,
                        warm_start=self.fanout_warm_start,
                        **reg_kw,
                        **common,
                    )
                elif kind == "joint_gp":
                    # All distinct induce_counts train in ONE batched
                    # padded program (sysid/gp.py:train_svgp_buckets —
                    # exact no-op padding, so each bucket equals the
                    # reference's per-candidate training with the same
                    # data + seed) and the closed loop runs per-lane
                    # cached-mean-weights predictors.
                    from ..parallel.fanout import JointGPQuadCostFanout

                    fanouts[key] = JointGPQuadCostFanout(
                        system, task,
                        dict(
                            niter=int(m_over.get("niter", 5)),
                            lr=float(m_over.get("lr", 0.1)),
                            batch_size=int(m_over.get("batch_size", 1024)),
                            seed=int(m_over.get("seed", 100)),
                        ),
                        sysid_trajs, surrogate, horizon=key,
                        compact_schedule=self.fanout_compact,
                        warm_start=self.fanout_warm_start,
                        **reg_kw,
                        **common,
                    )
                else:
                    fanouts[key] = DirectTranscriptionFanout(
                        system, task, pipeline.model, surrogate,
                        horizon_knots=key, **reg_kw, **common,
                    )
            # Per-lane diagonals from the QuadCostFactory subspace (its
            # prefix is "" for a bare factory, "_sum_i:" inside a
            # SumCostFactory; zeros when the candidate space has no quad
            # term — pure GaussRegFactory).
            Qd, Fd, Rd = [], [], []
            for i in idxs:
                cfg = cfgs[i]
                if qp is None:
                    Qd.append([0.0] * len(system.observations))
                    Fd.append([0.0] * len(system.observations))
                    Rd.append([0.0] * len(system.controls))
                else:
                    Qd.append([
                        cfg.get(f"_cost:{qp}{o}_Q", 0.0)
                        for o in system.observations
                    ])
                    Fd.append([
                        cfg.get(f"_cost:{qp}{o}_F", 0.0)
                        for o in system.observations
                    ])
                    Rd.append([
                        cfg.get(f"_cost:{qp}{c}_R", 0.0)
                        for c in system.controls
                    ])
            batch = {
                "Qdiag": jnp.asarray(np.array(Qd, dtype=float)),
                "Fdiag": jnp.asarray(np.array(Fd, dtype=float)),
                "Rdiag": jnp.asarray(np.array(Rd, dtype=float)),
            }
            if rp is not None:
                batch["regw"] = jnp.asarray([
                    float(cfgs[i].get(f"_cost:{rp}reg_weight", 1.0))
                    for i in idxs
                ])
            if kind == "mppi":
                batch["sigma"] = jnp.asarray(
                    [float(ck(cfgs[i], "sigma", 1.0)) for i in idxs]
                )
                batch["lmda"] = jnp.asarray(
                    [float(ck(cfgs[i], "lmda", 1.0)) for i in idxs]
                )
            elif kind == "joint_sindy":
                method = dict(key[0])["method"]
                reg_name = (
                    "lasso_alpha" if method == "lasso" else "threshold"
                )
                reg_def = 1.0 if method == "lasso" else 1e-2
                batch["reg"] = jnp.asarray(
                    [float(mk(cfgs[i], reg_name, reg_def)) for i in idxs]
                )
            elif kind == "joint_koopman" and key[0] == "lasso":
                batch["reg"] = jnp.asarray(
                    [float(mk(cfgs[i], "lasso_alpha", 1.0)) for i in idxs]
                )
            elif kind == "joint_gp":
                batch["induce_count"] = np.array(
                    [int(mk(cfgs[i], "induce_count", 100)) for i in idxs]
                )
            elif kind == "joint_mlp":
                L = key[0]
                widths = []
                for i in idxs:
                    base = int(mk(cfgs[i], "hidden_size", 128))
                    widths.append(tuple(
                        int(mk(cfgs[i], f"hidden_size_{j + 1}", base))
                        for j in range(L)
                    ))
                batch["widths"] = tuple(widths)
                batch["lr"] = jnp.asarray(
                    [float(mk(cfgs[i], "lr", 1e-3)) for i in idxs]
                )
                if hmask_on:
                    batch["horizons"] = np.array(
                        [int(ck(cfgs[i], "horizon", 20)) for i in idxs]
                    )
            vals = np.asarray(fanouts[key](batch))
            for j, i in enumerate(idxs):
                costs[i] = float(vals[j])
        return costs

    def _get_surrogate(self, pipeline, trajs, rng, surrogate_tune_iters):
        surrogate_tune_result = None
        if self.surrogate_mode == "defaultcfg":
            cs = self.surrogate_factory.get_configuration_space()
            surrogate = self.surrogate_factory(cs.get_default_configuration(), trajs)
        elif self.surrogate_mode == "fixedcfg":
            surrogate = self.surrogate_factory(self.surrogate_cfg, trajs)
        elif self.surrogate_mode in ("autotune", "autoselect"):
            evaluator = self.surrogate_evaluator
            if evaluator is None:
                evaluator = HoldoutModelEvaluator(
                    system=pipeline.system,
                    trajs=trajs,
                    metric=self.surrogate_tune_metric,
                    rng=rng,
                    holdout_prop=self.surrogate_tune_holdout,
                )
            model_tuner = ModelTuner(pipeline.system, evaluator,
                                     eval_batch=self.eval_batch)
            if self.surrogate_mode == "autotune":
                model_tuner.add_model_factory(self.surrogate_factory)
            else:
                for factory_cls in _autoselect_factories():
                    model_tuner.add_model_factory(factory_cls(pipeline.system))
            surrogate, surrogate_tune_result = model_tuner.run(
                rng, n_iters=surrogate_tune_iters
            )
        elif self.surrogate_mode == "pretrain":
            # "pretrain" means the caller supplies an already-trained
            # surrogate via run(surrogate=...); run() short-circuits
            # before reaching here, so landing in this branch means no
            # surrogate was passed. The reference leaves this case
            # unhandled (its _get_surrogate falls through with
            # ``surrogate`` unbound -> UnboundLocalError,
            # pipeline_tuner.py:116-150); we raise a clear error.
            raise ValueError(
                'surrogate_mode="pretrain" requires passing a trained '
                "surrogate model via run(surrogate=...)"
            )
        else:
            raise ValueError(f"Unknown surrogate_mode {self.surrogate_mode}")
        return surrogate, surrogate_tune_result

    def run(
        self,
        pipeline,
        task,
        trajs,
        n_iters,
        rng,
        surrogate=None,
        truedyn=None,
        surrogate_tune_iters=100,
        eval_cfg_hook=None,
        checkpoint_path=None,
    ):
        """Run tuning; returns (final controller, PipelineTuneResult).

        With ``checkpoint_path``, the tuner snapshots its full state
        after every evaluated batch and resumes from an existing
        snapshot (first-class resume; the reference's SMAC runs are not
        resumable, SURVEY §5)."""
        trajs = list(trajs) if not hasattr(trajs, "to_list") else trajs.to_list()
        self._reg_stats = None  # per-run GaussReg statistics cache
        if surrogate is None:
            surr_size = int(self.surrogate_split * len(trajs))
            shuffled = trajs[:]
            rng.shuffle(shuffled)
            surr_trajs_set = shuffled[:surr_size]
            sysid_trajs = shuffled[surr_size:]
            surrogate, surr_tune_result = self._get_surrogate(
                pipeline, surr_trajs_set, rng, surrogate_tune_iters
            )
        else:
            sysid_trajs = trajs
            surr_tune_result = None

        def eval_cfg(cfg):
            info = {}
            try:
                controller, new_task, model = pipeline(cfg, task, sysid_trajs)
                controller.reset()
                if task.has_num_steps():
                    surr_traj = simulate(
                        controller, task.get_init_obs(), task.term_cond,
                        sim_model=surrogate, max_steps=task.get_num_steps(),
                    )
                else:
                    surr_traj = simulate(
                        controller, task.get_init_obs(), task.term_cond,
                        sim_model=surrogate,
                    )
                cost = task.get_cost()
                surr_cost = float(cost(surr_traj))
                if not np.isfinite(surr_cost):
                    surr_cost = float("inf")
                info["surr_cost"] = surr_cost
                info["surr_traj"] = surr_traj
            except (np.linalg.LinAlgError, FloatingPointError, ValueError):
                surr_cost = float("inf")
                info["surr_cost"] = surr_cost
                info["surr_traj"] = None
                model = None

            if truedyn is not None and model is not None:
                try:
                    controller, _, _ = pipeline(cfg, task, sysid_trajs, model=model)
                    controller.reset()
                    if task.has_num_steps():
                        truedyn_traj = simulate(
                            controller, task.get_init_obs(), task.term_cond,
                            dynamics=truedyn, max_steps=task.get_num_steps(),
                        )
                    else:
                        truedyn_traj = simulate(
                            controller, task.get_init_obs(), task.term_cond,
                            dynamics=truedyn,
                        )
                    info["truedyn_cost"] = float(task.get_cost()(truedyn_traj))
                    info["truedyn_traj"] = truedyn_traj
                except (np.linalg.LinAlgError, FloatingPointError, ValueError):
                    info["truedyn_cost"] = float("inf")
                    info["truedyn_traj"] = None
            if eval_cfg_hook is not None:
                eval_cfg_hook(cfg, info)
            return surr_cost, info

        space = pipeline.get_configuration_space()
        bo = BatchBayesOpt(space, rng=rng, batch_size=self.eval_batch)

        cfgs, costs, infos = [], [], []
        if checkpoint_path is not None:
            import os

            from ..utils.checkpoint import (
                bo_load_state,
                load_checkpoint,
                save_checkpoint,
            )

            if os.path.exists(checkpoint_path):
                snap = load_checkpoint(checkpoint_path)
                bo_load_state(bo, snap["bo"])
                cfgs = [
                    space.configuration_from_dict(d) for d in snap["cfg_dicts"]
                ]
                costs = list(snap["costs"])
                infos = [{"surr_cost": c, "surr_traj": None} for c in costs]

        fanout_kind, fanout_reason = self._fanout_kind(pipeline, surrogate)
        if self.use_fanout and fanout_kind is None:
            import warnings

            warnings.warn(
                "use_fanout=True but this pipeline has no fan-out fast "
                f"path ({fanout_reason}); falling back to the "
                "sequential per-candidate objective",
                stacklevel=2,
            )
        fanouts = {}
        fanouts_true = {}
        oracle = None
        if fanout_kind is not None and truedyn is not None:
            # True-dynamics reporting rides the same sharded fan-out:
            # the traceable ground-truth dynamics act as a perfect
            # "surrogate" through the FunctionModel oracle wrapper.
            from ..sysid.dummy import FunctionModel

            oracle = FunctionModel(pipeline.system, truedyn)
        remaining = int(n_iters) - len(costs)
        while remaining > 0:
            batch = bo.ask(min(self.eval_batch, remaining))
            if fanout_kind is not None:
                batch_costs = self._eval_batch_fanout(
                    pipeline, task, surrogate, batch, fanouts, fanout_kind,
                    sysid_trajs=sysid_trajs,
                )
                if oracle is not None:
                    true_costs = self._eval_batch_fanout(
                        pipeline, task, oracle, batch, fanouts_true,
                        fanout_kind, sysid_trajs=sysid_trajs,
                    )
                    for c, tc in zip(batch_costs, true_costs):
                        infos.append({
                            "surr_cost": c, "surr_traj": None,
                            "truedyn_cost": tc, "truedyn_traj": None,
                        })
                else:
                    for c in batch_costs:
                        infos.append({"surr_cost": c, "surr_traj": None})
            else:
                batch_costs = []
                for cfg in batch:
                    c, info = eval_cfg(cfg)
                    batch_costs.append(c)
                    infos.append(info)
            bo.tell(batch, batch_costs)
            cfgs.extend(batch)
            costs.extend(batch_costs)
            remaining -= len(batch)
            if checkpoint_path is not None:
                from ..utils.checkpoint import bo_state_dict, save_checkpoint

                save_checkpoint(
                    checkpoint_path,
                    {
                        "kind": "pipeline_tune",
                        "bo": bo_state_dict(bo),
                        "cfg_dicts": [c.get_dictionary() for c in cfgs],
                        "costs": list(costs),
                    },
                )

        # Reconstruct incumbent history (pipeline_tuner.py:277-303).
        inc_cost = float("inf")
        inc_cfg = None
        inc_truedyn_cost = float("inf")
        inc_cfgs, inc_costs = [], []
        truedyn_costs, inc_truedyn_costs = [], []
        surr_trajs, truedyn_trajs = [], []
        for cfg, cost, info in zip(cfgs, costs, infos):
            if cost < inc_cost:
                inc_cost = cost
                inc_cfg = cfg
                if "truedyn_cost" in info:
                    inc_truedyn_cost = info["truedyn_cost"]
            inc_costs.append(inc_cost)
            inc_cfgs.append(inc_cfg)
            surr_trajs.append(info.get("surr_traj"))
            if "truedyn_cost" in info:
                truedyn_costs.append(info["truedyn_cost"])
                inc_truedyn_costs.append(inc_truedyn_cost)
                truedyn_trajs.append(info.get("truedyn_traj"))

        tune_result = PipelineTuneResult(
            inc_cfg=inc_cfg,
            cfgs=cfgs,
            inc_cfgs=inc_cfgs,
            costs=costs,
            inc_costs=inc_costs,
            truedyn_costs=truedyn_costs,
            inc_truedyn_costs=inc_truedyn_costs,
            surr_trajs=surr_trajs,
            truedyn_trajs=truedyn_trajs,
            surr_tune_result=surr_tune_result,
        )

        controller, _, _ = pipeline(inc_cfg, task, sysid_trajs)
        return controller, tune_result
