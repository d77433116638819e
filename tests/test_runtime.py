"""Entry-point set-up: the persistent compile cache and the device
record every benchmark row carries."""

import os
import subprocess
import sys

import jax

from autompc_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper
    sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_reaches_jax_in_fresh_process(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    code = (
        "import jax; from autompc_tpu.utils.runtime import "
        "enable_compile_cache as e; p = e(); "
        "print(p == jax.config.jax_compilation_cache_dir)"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("True")


def test_device_info_on_cpu():
    info = runtime.device_info()
    assert info["platform"] == "cpu"
    assert info["device_count"] == len(jax.devices())
    assert info["gpu_name_power_limit"] == "not available"
