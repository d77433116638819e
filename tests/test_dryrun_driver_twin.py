"""Twin test for the multi-device dry run.

Runs ``dryrun_multichip`` the way a user runs it by hand: a fresh
subprocess, no conftest, no JAX_ENABLE_X64 (plain float32), 8 forced
host-platform CPU devices. The suite itself enables x64, so this catches
tolerances that only hold in float64.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_fresh_f32_subprocess():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_ENABLE_X64", "JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [
            sys.executable, "-c",
            "import sys; sys.path.insert(0, %r)\n"
            "from __graft_entry__ import dryrun_multichip\n"
            "dryrun_multichip(8)\n"
            "print('DRYRUN_TWIN_OK')" % REPO,
        ],
        capture_output=True, text=True, env=env, timeout=580, cwd=REPO,
    )
    assert r.returncode == 0, (
        f"driver-twin dryrun failed (rc={r.returncode}):\n"
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-4000:]}"
    )
    assert "DRYRUN_TWIN_OK" in r.stdout
