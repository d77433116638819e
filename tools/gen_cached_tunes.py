"""Generate the shipped cached-tune assets (reference parity:
assets/cached_tunes/cartpole_tune_result.pkl, loaded by
cartpole_v2.py:146-153; here extended to halfcheetah per the ICRA
comparison workflow).

Usage:  python tools/gen_cached_tunes.py {cartpole|halfcheetah}

Runs a fan-out PipelineTuner tune (one sharded program per candidate
batch) and checkpoints the result under assets/cached_tunes/. Cartpole
runs fine on CPU (prefix ``PYTHONPATH= JAX_PLATFORMS=cpu``); the
halfcheetah tune wants the GPU.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def gen_cartpole():
    from autompc_tpu.benchmarks import CartpoleSwingupV2Benchmark
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCostFactory
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import SINDy
    from autompc_tpu.tuning import PipelineTuner

    b = CartpoleSwingupV2Benchmark()
    trajs = b.gen_trajs(seed=42, n_trajs=40, traj_len=80)
    model = SINDy(b.system, method="lstsq", threshold=1e-3, trig_basis=True,
                  trig_freq=1, trig_interaction=True, time_mode="discrete")
    model.train(trajs)
    pipeline = Pipeline(
        b.system, model,
        QuadCostFactory(b.system, goal=np.zeros(4)),
        IterativeLQRFactory(b.system),
    )
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=4,
                          use_fanout=True)
    _, result = tuner.run(
        pipeline, b.task.copy(), trajs, n_iters=64,
        rng=np.random.default_rng(0), surrogate=model,
    )
    return "cartpole_tune_result.ckpt", result


def gen_halfcheetah():
    """Quad-gain tune of an MLP-model iLQR pipeline on the true 200-R
    metric (its telescoped stage/terminal form drives the fan-out)."""
    from autompc_tpu.benchmarks import HalfcheetahBenchmark
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCostFactory
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.sysid import MLP
    from autompc_tpu.tuning import PipelineTuner

    b = HalfcheetahBenchmark()
    trajs = b.gen_trajs_batch(seed=0, n_trajs=48, traj_len=60).to_list()
    model = MLP(b.system, n_hidden_layers=2, hidden_size=64,
                n_train_iters=40, n_batch=64)
    model.train(trajs)
    goal = np.asarray(b.task.get_init_obs())
    pipeline = Pipeline(
        b.system, model,
        QuadCostFactory(b.system, goal=goal),
        IterativeLQRFactory(b.system, horizon=8),
    )
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=8,
                          use_fanout=True)
    task = b.task.copy()
    task.set_num_steps(120)
    _, result = tuner.run(
        pipeline, task, trajs, n_iters=32,
        rng=np.random.default_rng(0), surrogate=model,
    )
    return "halfcheetah_tune_result.ckpt", result


def main():
    from autompc_tpu.utils.checkpoint import save_checkpoint

    which = sys.argv[1] if len(sys.argv) > 1 else "cartpole"
    fname, result = {"cartpole": gen_cartpole,
                     "halfcheetah": gen_halfcheetah}[which]()
    out = os.path.join(
        os.path.dirname(__file__), "..", "assets", "cached_tunes", fname
    )
    save_checkpoint(out, {
        "kind": "pipeline_tune_result",
        "inc_cfg": result.inc_cfg.get_dictionary(),
        "cfg_dicts": [c.get_dictionary() for c in result.cfgs],
        "costs": list(result.costs),
        "inc_costs": list(result.inc_costs),
    })
    print("incumbent cost:", result.inc_costs[-1])
    print("incumbent:", result.inc_cfg)
    print("saved", out)


if __name__ == "__main__":
    main()
