"""Golden-pinned fixed-seed GaussReg/SumCost tuning run.

The per-term GaussReg/SumCost costs are pinned by unit tests
(test_costs.py) and the fan-out==sequential parity by test_tuning.py;
this pins the remaining piece — the BO INTERACTION: the exact
ask/tell cost history and incumbent progression of a fixed-seed
PipelineTuner run over the SumCostFactory(QuadCostFactory +
GaussRegFactory) space (reference semantics:
autompc/costs/gauss_reg_factory.py:37-45 +
autompc/tuning/pipeline_tuner.py history reconstruction).

Golden values: tests/golden/gauss_reg_tune_golden.json, generated by
tools/gen_golden_tune.py on the test environment (CPU, x64).
Regenerate ONLY for intentional search-behavior changes.
"""

import json
import os

import numpy as np
import pytest

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "gauss_reg_tune_golden.json"
)


@pytest.mark.slow
def test_gauss_reg_sum_cost_tune_matches_golden():
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "tools")
    )
    from gen_golden_tune import run_tune

    with open(GOLDEN) as f:
        golden = json.load(f)

    res = run_tune()
    np.testing.assert_allclose(
        np.asarray(res.costs, dtype=float),
        np.asarray(golden["costs"], dtype=float),
        rtol=1e-9,
        err_msg="evaluated-cost history diverged from the golden tune",
    )
    np.testing.assert_allclose(
        np.asarray(res.inc_costs, dtype=float),
        np.asarray(golden["inc_costs"], dtype=float),
        rtol=1e-9,
        err_msg="incumbent-cost curve diverged from the golden tune",
    )
    for k, v in golden["inc_cfg"].items():
        got = res.inc_cfg[k]
        if isinstance(v, float):
            assert got == pytest.approx(v, rel=1e-9), (k, got, v)
        else:
            assert got == v, (k, got, v)
    # The curve must actually discriminate (guards against a future
    # fixture regression back to a saturated constant metric).
    assert len(set(round(c, 6) for c in golden["costs"])) > 1


JOINT_GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "joint_sindy_tune_golden.json"
)


@pytest.mark.slow
def test_joint_sindy_tune_matches_golden():
    """Golden-pinned flagship JOINT tune: the BO trajectory of a
    fixed-seed SINDy+QuadCost+iLQR tune routed through the joint_sindy
    fan-out."""
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "tools")
    )
    from gen_golden_joint_tune import run_tune

    with open(JOINT_GOLDEN) as f:
        golden = json.load(f)

    res = run_tune()
    np.testing.assert_allclose(
        np.asarray(res.costs, dtype=float),
        np.asarray(golden["costs"], dtype=float),
        rtol=1e-9,
        err_msg="joint-tune evaluated-cost history diverged from golden",
    )
    np.testing.assert_allclose(
        np.asarray(res.inc_costs, dtype=float),
        np.asarray(golden["inc_costs"], dtype=float),
        rtol=1e-9,
        err_msg="joint-tune incumbent-cost curve diverged from golden",
    )
    for k, v in golden["inc_cfg"].items():
        got = res.inc_cfg[k]
        if isinstance(v, float):
            assert got == pytest.approx(v, rel=1e-9), (k, got, v)
        else:
            assert got == v, (k, got, v)
    assert len(set(round(c, 6) for c in golden["costs"])) > 1
