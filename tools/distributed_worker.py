"""Multi-process ``jax.distributed`` smoke worker.

Validates the multi-process bootstrap path the framework's multi-host
story rests on (parallel/mesh.py: "call jax.distributed.initialize() before
building the mesh"), with N CPU processes x 4 virtual devices each
standing in for N hosts — no pod required. Exercised by
tests/test_distributed.py with two processes; usable standalone:

    python tools/distributed_worker.py --coordinator localhost:9999 \
        --pid 0 --nproc 2 &
    python tools/distributed_worker.py --coordinator localhost:9999 \
        --pid 1 --nproc 2

Each worker runs three programs over the GLOBAL mesh and checks them
against single-process references computed locally (every process holds
the same host-side batch, so any process can verify its own shards):

1. shard_map psum over the global ``config`` axis (the collective
   actually crosses the process boundary);
2. the QuadCostFanout tuning objective — iLQR synthesis + closed-loop
   surrogate rollout per candidate — sharded over all processes'
   devices, shards compared to a local single-device evaluation;
3. a data-parallel MLP training step with the minibatch sharded across
   processes (XLA inserts the gradient psum across processes), loss
   compared to the single-device full-batch step.

Prints ``DISTRIBUTED_OK <pid>`` on success.
"""

import argparse
import os
import sys

# Runnable from any directory: the repo root goes on the path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cpu_backend(n_local: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_local}"
        ).strip()
    import jax

    return jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()

    jax = _cpu_backend(args.local_devices)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    print(f"[worker {args.pid}] initializing...", file=sys.stderr, flush=True)
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nproc,
        process_id=args.pid,
    )
    print(
        f"[worker {args.pid}] up: {jax.process_count()} processes, "
        f"{jax.device_count()} global devices",
        file=sys.stderr, flush=True,
    )
    n_global = args.nproc * args.local_devices
    assert jax.process_count() == args.nproc
    assert jax.device_count() == n_global, (
        jax.device_count(), n_global,
    )

    from autompc_tpu.parallel.mesh import global_batch, make_mesh

    mesh = make_mesh()  # all global devices on one "config" axis
    assert mesh.devices.size == n_global

    # --- 1. cross-process collective ------------------------------
    ones = global_batch(np.ones(n_global), mesh)

    def count(x):
        return jax.lax.psum(x, "config")

    total = jax.jit(
        jax.shard_map(
            count, mesh=mesh, in_specs=P("config"), out_specs=P("config")
        )
    )(ones)
    shard0 = np.asarray(total.addressable_shards[0].data)
    assert float(shard0[0]) == float(n_global), shard0
    print(f"[worker {args.pid}] psum ok", file=sys.stderr, flush=True)

    # --- 2. tuning fan-out over the global mesh -------------------
    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
    from autompc_tpu.parallel import QuadCostFanout
    from autompc_tpu.sysid import SINDy

    benchmark = CartpoleSwingupBenchmark()
    trajs = benchmark.gen_trajs_batch(seed=0, n_trajs=8, traj_len=16)
    model = SINDy(
        benchmark.system, method="lstsq", threshold=1e-3,
        trig_basis=True, trig_freq=1, trig_interaction=True,
        time_mode="discrete",
    )
    model.train(trajs)

    B = n_global  # one candidate per device: no padding, no slicing
    rng = np.random.default_rng(0)
    host_batch = {
        "Qdiag": rng.uniform(0.5, 5.0, (B, 4)),
        "Fdiag": rng.uniform(0.5, 5.0, (B, 4)),
        "Rdiag": rng.uniform(0.01, 1.0, (B, 1)),
    }
    common = dict(horizon=5, n_steps=6, goal=np.zeros(4))
    fan_global = QuadCostFanout(
        benchmark.system, benchmark.task, model, model, mesh=mesh,
        **common,
    )
    gbatch = global_batch(host_batch, mesh)
    costs = fan_global(gbatch)
    jax.block_until_ready(costs)

    # Local single-device reference over the full batch.
    fan_local = QuadCostFanout(
        benchmark.system, benchmark.task, model, model, mesh=None,
        **common,
    )
    ref = np.asarray(
        fan_local({k: jnp.asarray(v) for k, v in host_batch.items()})
    )
    for shard in costs.addressable_shards:
        lo = shard.index[0].start or 0
        got = np.asarray(shard.data)
        want = ref[lo : lo + got.shape[0]]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    print(f"[worker {args.pid}] fanout ok", file=sys.stderr, flush=True)

    # --- 3. data-parallel MLP step across processes ---------------
    import optax

    from autompc_tpu.sysid import MLP
    from autompc_tpu.sysid.mlp import net_apply

    mlp = MLP(benchmark.system, n_hidden_layers=1, hidden_size=16)
    params = mlp.net_params
    opt = optax.adam(1e-3)

    dp_mesh = make_mesh(axis_names=("data",))
    repl = NamedSharding(dp_mesh, P())

    def loss_fn(p, x, y):
        pred = net_apply(p, x, "relu")
        return jnp.mean((pred - y) ** 2)

    @jax.jit
    def train_step(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    n = 4 * n_global
    host_x = np.asarray(
        np.linspace(-1, 1, n * 5, dtype=np.float64).reshape(n, 5)
    )
    host_y = np.zeros((n, 4))
    x = global_batch(host_x, dp_mesh, "data")
    y = global_batch(host_y, dp_mesh, "data")
    gparams = jax.device_put(params, repl)
    gopt = jax.device_put(opt.init(params), repl)
    new_params, _, loss = train_step(gparams, gopt, x, y)
    jax.block_until_ready(loss)

    # Single-device full-batch reference.
    ref_params, _, ref_loss = train_step(
        params, opt.init(params), jnp.asarray(host_x), jnp.asarray(host_y)
    )
    # f32: the sharded mean reduces per-shard then psums, so the
    # reduction tree differs from the single-device full-batch mean —
    # agreement is to reassociation noise, not bitwise.
    assert abs(float(loss) - float(ref_loss)) < 1e-6 * (
        1.0 + abs(float(ref_loss))
    ), (float(loss), float(ref_loss))
    leaves = jax.tree_util.tree_leaves(new_params)
    ref_leaves = jax.tree_util.tree_leaves(ref_params)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(
            np.asarray(a.addressable_shards[0].data),
            np.asarray(b), rtol=1e-5, atol=1e-7,
        )

    print(f"DISTRIBUTED_OK {args.pid}", flush=True)


if __name__ == "__main__":
    main()
