"""Two-process ``jax.distributed`` validation.

Launches tools/distributed_worker.py twice (4 virtual CPU devices per
process = an 8-device global mesh across a real process boundary) and
asserts both workers pass their in-worker checks: a cross-process
shard_map psum, the QuadCostFanout tuning objective sharded over the
global mesh vs a local single-device reference, and a data-parallel MLP
training step (gradient psum over the process boundary) vs the
single-device full-batch step.

This exercises the actual multi-process bootstrap path
(``jax.distributed.initialize``) that parallel/mesh.py's multi-host
entry documents — previously only single-process virtual meshes were
tested.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(
    os.path.dirname(__file__), "..", "tools", "distributed_worker.py"
)

pytestmark = pytest.mark.slow


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable, WORKER,
                "--coordinator", f"localhost:{port}",
                "--pid", str(pid), "--nproc", "2",
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"distributed workers timed out; partial: {outs}")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DISTRIBUTED_OK {pid}" in out, out[-4000:]
