"""Set-up shared by the entry points (benchmarks, ``chip_smoke.py``,
tools): the persistent compile cache and the record of the device a
result was measured on."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# The checkout that holds this package: <checkout>/autompc_tpu/utils/.
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set. Otherwise the cache is ``<checkout>/.jax_cache``
    (listed in .gitignore): a fixed path, because the path is part of
    the cache key and a directory that moves never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or "not available" without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.splitlines()[0] if out else "not available"


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit; every benchmark row records these."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "gpu_name_power_limit": (
            gpu_name_and_power_limit() if devs[0].platform == "gpu"
            else "not available"
        ),
    }
