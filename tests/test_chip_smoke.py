"""chip_smoke.py's comparison helpers at small sizes, and its refusal to
run without a GPU or without the rest of the repository."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_quad_objective_matches_loop():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(3, 6, 4))
    us = rng.normal(size=(3, 5, 1))
    Qd, Rd, Fd = np.array([1.0, 2, 3, 4]), np.array([0.5]), np.ones(4)
    goal, dt = np.array([0.1, 0, 0, 0]), 0.05
    got = cs.quad_objective(xs, us, Qd, Rd, Fd, goal, dt)
    for b in range(3):
        stage = sum(
            (xs[b, t] - goal) @ np.diag(Qd) @ (xs[b, t] - goal)
            + us[b, t] @ np.diag(Rd) @ us[b, t]
            for t in range(5)
        )
        term = (xs[b, 5] - goal) @ (xs[b, 5] - goal)
        assert got[b] == pytest.approx(dt * stage + term)


@pytest.mark.parametrize(
    "case,ok",
    [("identical", True), ("split_lanes", True), ("biased", False),
     ("converged_fewer", False), ("nonfinite", False)],
)
def test_compare_solves(case, ok):
    rng = np.random.default_rng(1)
    n = 4000
    obj = rng.uniform(1.0, 10.0, n)
    conv = rng.uniform(size=n) < 0.7
    obj_a, conv_a = obj.copy(), conv.copy()
    if case == "split_lanes":
        # A few percent of lanes settle elsewhere, unbiased.
        idx = rng.choice(n, 200, replace=False)
        obj_a[idx] *= rng.choice([0.9, 1.1], 200)
        conv_a[idx[:20]] = ~conv_a[idx[:20]]
    elif case == "biased":
        obj_a = obj_a * 1.05
    elif case == "converged_fewer":
        conv_a[np.flatnonzero(conv_a)[:400]] = False
    elif case == "nonfinite":
        obj_a[np.flatnonzero(conv_a)[0]] = np.nan
    res = cs.compare_solves(obj_a, conv_a, obj, conv)
    assert res["ok"] is ok, res
    if case == "identical":
        assert res["share_within_rtol"] == 1.0 and res["mean_rel"] == 0.0


def test_conv_tolerance_has_a_floor():
    conv = np.ones(10, bool)
    res = cs.compare_solves(np.ones(10), conv, np.ones(10), conv)
    assert res["conv_tol"] == pytest.approx(cs.CONV_POINTS / 100)


def test_rel_max_err_and_lanes_agreeing():
    b = np.array([[1.0, -4.0], [2.0, 0.0]])
    assert cs.rel_max_err(b + 0.04, b) == pytest.approx(0.01)
    us_ref = np.zeros((3, 4, 1))
    us = us_ref.copy()
    us[1, 2, 0] = 0.5
    np.testing.assert_array_equal(cs.lanes_agreeing(us, us_ref),
                                  [True, False, True])


def test_swing_up_success():
    xs = np.zeros((3, 5, 4))
    xs[1, -1, 0] = 0.3
    xs[2, -1, 1] = -0.25
    np.testing.assert_array_equal(cs.swing_up_success(xs),
                                  [True, False, False])


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_fails_without_gpu():
    r = _run(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert not any(
        line.strip().startswith("{") and "ok" in json.loads(line)
        for line in r.stdout.splitlines() if line.strip().startswith("{")
    )
