"""Quantify the halfcheetah stand-in against real MuJoCo.

The reference benchmark's ground truth IS MuJoCo (reference
autompc/benchmarks/halfcheetah.py:187-202, gym HalfCheetah via
mujoco_py); this repo's oracle is a from-scratch planar Lagrangian
simulator (autompc_tpu/benchmarks/halfcheetah.py). Until the two are
compared quantitatively, "halfcheetah parity" is a naming claim. This
tool rolls IDENTICAL seeded control sequences through both and reports:

* one-step prediction error along the MuJoCo trajectory (re-synced
  every env step — instantaneous dynamics fidelity, the honest metric
  for a chaotic contact-rich system),
* k-step open-loop state divergence (k = 5, 25, 100),
* reward-scale ratio (gym running reward computed on both rollouts).

Parameter variants measured in the same run (CHEETAH_VARIANTS):
  base          the committed oracle (mu=0.8, no armature)
  mjcf          mu=0.4 (the MJCF geom friction) + armature 0.1 (the
                MJCF joint default) — candidate fidelity fixes

Usage (CPU; mujoco is host-only):
    PYTHONPATH= JAX_PLATFORMS=cpu python tools/check_cheetah_vs_mujoco.py
Outputs a table + one JSON line (machine-checkable artifact).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MJCF = (
    "/opt/venv/lib/python3.12/site-packages/gymnasium/envs/mujoco/"
    "assets/half_cheetah.xml"
)
FRAME_SKIP = 5  # gym HalfCheetah: dt 0.01 x 5 = the env's 0.05 s step


def mujoco_rollout(m, d, x0, us):
    """Roll us (T, 6) from x0 (18,) with mujoco; returns (T+1, 18).
    State convention: our q[1] is ABSOLUTE torso height; mujoco's
    rootz slide displaces from the body's 0.7 m reference."""
    import mujoco

    T = us.shape[0]
    out = np.zeros((T + 1, 18))
    mujoco.mj_resetData(m, d)
    d.qpos[:] = x0[:9]
    d.qpos[1] -= 0.7
    d.qvel[:] = x0[9:]
    mujoco.mj_forward(m, d)
    out[0] = x0
    for t in range(T):
        d.ctrl[:] = np.clip(us[t], -1, 1)
        for _ in range(FRAME_SKIP):
            mujoco.mj_step(m, d)
        out[t + 1, :9] = d.qpos
        out[t + 1, 1] += 0.7
        out[t + 1, 9:] = d.qvel
    return out


def main():
    import mujoco

    import jax
    import jax.numpy as jnp

    from autompc_tpu.benchmarks import halfcheetah as hc

    m = mujoco.MjModel.from_xml_path(MJCF)
    d = mujoco.MjData(m)
    assert abs(m.opt.timestep * FRAME_SKIP - 0.05) < 1e-12

    K = int(os.environ.get("CHEETAH_EPISODES", "16"))
    T = int(os.environ.get("CHEETAH_STEPS", "100"))
    rng = np.random.default_rng(7)

    # gym-style resets: qpos0 + U(-0.1, 0.1), qvel ~ 0.1 N(0,1)
    x0s, uss = [], []
    for k in range(K):
        qpos = np.zeros(9)
        qpos[1] = 0.7
        qpos += rng.uniform(-0.1, 0.1, 9)
        qvel = 0.1 * rng.standard_normal(9)
        x0s.append(np.concatenate([qpos, qvel]))
        uss.append(rng.uniform(-1, 1, (T, 6)))

    mj_trajs = [mujoco_rollout(m, d, x0s[k], uss[k]) for k in range(K)]

    variants = os.environ.get("CHEETAH_VARIANTS", "base,mjcf").split(",")
    results = {}
    for variant in variants:
        if variant == "base":
            hc._FRICTION_MU, hc._ARMATURE = 0.8, 0.0
        elif variant == "mjcf":
            hc._FRICTION_MU, hc._ARMATURE = 0.4, 0.1
        elif variant == "fric":
            hc._FRICTION_MU, hc._ARMATURE = 0.4, 0.0
        elif variant == "arm":
            hc._FRICTION_MU, hc._ARMATURE = 0.8, 0.1
        else:
            raise ValueError(variant)

        step = jax.jit(
            lambda x, u: hc.halfcheetah_dynamics(x, u)
        )
        step_v = jax.jit(jax.vmap(hc.halfcheetah_dynamics))

        # one-step errors along the mujoco trajectory (re-synced)
        xs_in = jnp.asarray(
            np.concatenate([tr[:-1] for tr in mj_trajs])
        )
        us_in = jnp.asarray(np.concatenate(uss))
        tgt = np.concatenate([tr[1:] for tr in mj_trajs])
        pred = np.asarray(step_v(xs_in, us_in))
        # displacement scale: how much the state actually moves per step
        disp = tgt - np.concatenate([tr[:-1] for tr in mj_trajs])
        e1 = np.abs(pred - tgt)
        scale_q = np.median(np.abs(disp[:, :9])) + 1e-9
        scale_v = np.median(np.abs(disp[:, 9:])) + 1e-9
        one_q = float(np.median(e1[:, :9]) / scale_q)
        one_v = float(np.median(e1[:, 9:]) / scale_v)

        # open-loop divergence
        div = {}
        ours = []
        for k in range(K):
            x = jnp.asarray(x0s[k])
            tr = [np.asarray(x)]
            for t in range(T):
                x = step(x, jnp.asarray(uss[k][t]))
                tr.append(np.asarray(x))
            ours.append(np.stack(tr))
        for kk in (5, 25, T):
            dq = [
                np.linalg.norm(ours[k][kk, :9] - mj_trajs[k][kk, :9])
                for k in range(K)
            ]
            div[kk] = float(np.median(dq))

        # reward scale: gym running reward on both open-loop rollouts
        def rew(tr, us_):
            fwd = (tr[-1, 0] - tr[0, 0]) / 0.05
            ctrl = 0.1 * float(np.sum(us_ ** 2))
            return fwd - ctrl

        r_mj = np.array([rew(mj_trajs[k], uss[k]) for k in range(K)])
        r_us = np.array([rew(ours[k], uss[k]) for k in range(K)])
        results[variant] = dict(
            one_step_qpos_rel=round(one_q, 4),
            one_step_qvel_rel=round(one_v, 4),
            div_qpos_5=round(div[5], 4),
            div_qpos_25=round(div[25], 4),
            div_qpos_T=round(div[T], 4),
            reward_mj_mean=round(float(r_mj.mean()), 2),
            reward_ours_mean=round(float(r_us.mean()), 2),
        )
        r = results[variant]
        print(
            f"[{variant:5s}] 1-step rel err: qpos {r['one_step_qpos_rel']:.3f} "
            f"qvel {r['one_step_qvel_rel']:.3f} | qpos div @5/25/{T}: "
            f"{r['div_qpos_5']:.3f}/{r['div_qpos_25']:.3f}/"
            f"{r['div_qpos_T']:.3f} | reward mj {r['reward_mj_mean']:.1f} "
            f"vs ours {r['reward_ours_mean']:.1f}",
            flush=True,
        )

    print(json.dumps({
        "metric": "cheetah_vs_mujoco",
        "episodes": K, "steps": T,
        "variants": results,
    }))


if __name__ == "__main__":
    main()
