"""Device-mesh utilities for config-level data parallelism.

The reference has no distributed backend at all (its only parallelism is
a dead multiprocessing path, autompc/control/mppi.py:347-391, and SMAC
evaluates one configuration at a time, pipeline_tuner.py:268-271). Here
parallel candidate evaluation is first-class: a 1-D ``config`` mesh axis
shards batches of tuning evaluations across chips, with XLA inserting
the collectives.

Multi-host entry: call ``jax.distributed.initialize()`` before building
the mesh and these utilities shard over the global device set. The mesh
follows the algorithm only: the cards of one host are joined all to all
(NVLink), so no axis order is preferred, and the candidate axis needs
collectives only at batch boundaries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("config",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a device mesh. Default: all devices on one ``config`` axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.array(devices).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def pad_to_multiple(batch, multiple: int, axis: int = 0):
    """Pad each leaf's leading axis up to a multiple; returns
    (padded_pytree, original_size)."""
    leaves = jax.tree_util.tree_leaves(batch)
    n = leaves[0].shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return batch, n

    def pad(x):
        pad_width = [(0, 0)] * x.ndim
        pad_width[axis] = (0, target - n)
        return jnp.pad(x, pad_width, mode="edge")

    return jax.tree_util.tree_map(pad, batch), n


def global_batch(batch, mesh: Mesh, axis: str = "config"):
    """Assemble per-process host data into GLOBAL sharded arrays for a
    multi-process mesh (every process holds the full host
    batch, contributes the rows its local devices own, and the result
    is one global array over the mesh).

    In single-process meshes this is a plain device_put. Each leaf's
    leading dim must divide evenly over the ``axis`` size.
    """
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        x = np.asarray(x)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        # Every process passes the FULL host batch; the explicit
        # global_shape tells jax to take only the slices this
        # process's devices own (omitting it would scale the global
        # shape by process_count).
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape=x.shape
        )

    return jax.tree_util.tree_map(put, batch)


def shard_vmap(fn, mesh: Optional[Mesh] = None, axis: str = "config"):
    """Lift ``fn`` (one evaluation) to a mesh-sharded batched evaluation:
    input pytrees are vmapped over their leading axis and sharded across
    ``axis``; results come back fully replicated on host.

    The returned callable pads ragged batches to the mesh size so the
    compiled program is reused for every batch size.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis,))
    n_dev = mesh.devices.size
    sharding = NamedSharding(mesh, P(axis))

    batched = jax.jit(
        jax.vmap(fn),
        in_shardings=sharding,
        out_shardings=sharding,
    )

    def call(batch):
        padded, n = pad_to_multiple(batch, n_dev)
        out = batched(padded)
        return jax.tree_util.tree_map(lambda x: x[:n], out)

    return call
