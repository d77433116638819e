"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh so sharding/collective
paths are exercised without a multi-card host, and with x64 enabled so
golden-value checks against float64 reference semantics are meaningful.
Hand-written GPU kernels run here in Pallas interpret mode (tests pass
``pallas_interpret=True``). Tests that only a card can run carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` covers them on
the GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------
# Test tiering: the compile-heavy tests (measured >= ~10 s each on the
# 8-device CPU mesh) are marked "slow". Measured in a FRESH container
# (cold JAX compile caches, round 3): smoke tier
# `pytest tests/ -m "not slow"` ~8 min; full suite ~36 min. Budget CI
# timeouts accordingly.
# Centralized here (plus explicit @pytest.mark.slow decorators in test
# files) so the tier list is maintained in one place.
# ---------------------------------------------------------------------

_SLOW = (
    "test_checkpoint_misc.py::TestPipelineTunerCheckpoint",
    "test_halfcheetah_tuning.py::",
    "test_halfcheetah.py::TestBenchmark::test_mlp_learns_dynamics",
    "test_tuning.py::TestPipelineTunerFanout",
    "test_tuning.py::TestPipelineTuner::test_small_pipeline_tune",
    "test_tuning.py::TestModelTuner::test_tunes_and_selects",
    "test_batched_ilqr.py::test_tvlqr_backward_assoc_matches_scan",
    "test_batched_ilqr.py::test_scheduled_compaction_matches_batched",
    "test_batched_ilqr.py::test_staged_compaction_matches_batched",
    "test_batched_ilqr.py::test_quad_cost_batch_per_lane",
    "test_batched_ilqr.py::test_batched_assoc_backward_matches_scan",
    "test_batched_ilqr.py::test_batch_params_matches_vmapped_single",
    "test_bucketed.py::",
    "test_parallel.py::TestBatchedFanoutCompaction",
    "test_koopman_dt.py::TestQPBackwardAssoc",
    "test_gp.py::TestApproximateGP::test_pred_diff_shapes",
    "test_fuzz_dims.py::test_quad_cost_batch_solver_all_dims",
    "test_joint_fanout.py::",
    "test_receding.py::test_receding_loop_matches_host_loop",
)


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest

    for item in items:
        nodeid = item.nodeid.replace("tests/", "", 1)
        if any(nodeid.startswith(p) or p in nodeid for p in _SLOW):
            item.add_marker(_pytest.mark.slow)
