"""Profiling and tracing utilities.

The reference has no systematic profiling — one ad-hoc wall-clock probe
(reference: autompc/sysid/largegp.py:123-139 ``pred_timeit``). Here
profiling is first-class: XLA traces via ``jax.profiler`` and honest
wall-clock timing that blocks on device completion (naive ``time.time``
around dispatch measures nothing under async dispatch).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/autompc_tpu_trace"):
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto:

        with profiling.trace("/tmp/trace"):
            run_workload()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timeit_fn(
    fn: Callable,
    *args,
    warmup: int = 1,
    reps: int = 5,
    name: Optional[str] = None,
    silent: bool = False,
):
    """Time a jax function with device-completion blocking.

    Returns (mean_seconds, result_of_last_call).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    mean = (time.perf_counter() - start) / reps
    if not silent:
        label = name or getattr(fn, "__name__", "fn")
        print(f"[timeit] {label}: {mean * 1e3:.3f} ms/call ({reps} reps)")
    return mean, out


def timeit_pipelined(
    fn: Callable,
    *args,
    warmup: int = 1,
    reps: int = 10,
    name: Optional[str] = None,
    silent: bool = False,
):
    """Time a jax function by queueing ``reps`` async dispatches and
    blocking ONCE at the end.

    ``timeit_fn`` blocks per call, so every rep pays the host<->device
    synchronization, and small kernels measure as dispatch latency.
    Pipelined dispatch amortizes it across all reps; use it whenever
    the per-call device time may be under a few dispatch latencies.
    Returns (mean_seconds, result_of_last_call).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    mean = (time.perf_counter() - start) / reps
    if not silent:
        label = name or getattr(fn, "__name__", "fn")
        print(
            f"[timeit-pipe] {label}: {mean * 1e3:.3f} ms/call ({reps} reps)"
        )
    return mean, out


def timeit_distinct(
    fn: Callable,
    inputs,
    warmup: int = 1,
    name: Optional[str] = None,
    silent: bool = False,
):
    """Time ``fn`` over a list of DISTINCT inputs, blocking once.

    Repeated same-input reps (``timeit_fn``/``timeit_pipelined``)
    re-run one input's data-dependent work (e.g. one convergence
    histogram of a batched solve); a different input per rep measures
    the distribution instead. ``inputs`` is a sequence of argument
    TUPLES; warmup runs the first ``warmup`` of them (their reps are
    excluded from timing).
    Returns (mean_seconds, result_of_last_call).
    """
    out = None
    for a in inputs[:warmup]:
        out = fn(*a)
    jax.block_until_ready(out)
    timed = inputs[warmup:] if warmup else inputs
    start = time.perf_counter()
    for a in timed:
        out = fn(*a)
    jax.block_until_ready(out)
    mean = (time.perf_counter() - start) / max(1, len(timed))
    if not silent:
        label = name or getattr(fn, "__name__", "fn")
        print(
            f"[timeit-distinct] {label}: {mean * 1e3:.3f} ms/call "
            f"({len(timed)} distinct reps)"
        )
    return mean, out


class StageTimer:
    """Accumulating named-stage wall-clock timer for pipeline phases
    (training, solving, rollout, tuning rounds)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:30s} {total:8.3f}s total  {total / n * 1e3:8.2f} ms/call  x{n}"
            )
        return "\n".join(lines)
