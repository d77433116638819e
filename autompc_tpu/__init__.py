"""autompc_tpu: an accelerator-native AutoML toolkit for system
identification and model-predictive control.

A from-scratch JAX/XLA/Pallas re-design of the capability set of AutoMPC
(reference layout: autompc/__init__.py:3-9): learned dynamics models
compile to pure JAX step functions, MPC optimizers run as fused XLA/Pallas
programs over batched rollouts, and the AutoML tuning loop evaluates
batches of candidate pipelines in parallel across a device mesh.
"""

from .core import (
    System,
    Trajectory,
    TrajectoryBatch,
    TimeStep,
    Task,
    zeros,
    empty,
    extend,
    from_arrays,
    batch,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import autompc_tpu` light and avoid import cycles
    # while still exposing the reference's root API surface
    # (autompc/__init__.py:3-9).
    if name in ("Model", "ModelFactory"):
        from .sysid import model as _m

        return getattr(_m, name)
    if name in ("Controller", "ControllerFactory"):
        from .control import controller as _c

        return getattr(_c, name)
    if name in ("Cost", "CostFactory", "QuadCost"):
        from . import costs as _costs

        return getattr(_costs, name)
    if name == "Pipeline":
        from .pipeline import Pipeline

        return Pipeline
    if name == "simulate":
        from .utils.simulation import simulate

        return simulate
    if name in ("make_model", "make_controller"):
        from .utils import make_utils as _mu

        return getattr(_mu, name)
    raise AttributeError(f"module 'autompc_tpu' has no attribute {name!r}")
