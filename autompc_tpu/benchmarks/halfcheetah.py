"""Halfcheetah benchmark with jax-native planar multibody dynamics.

Re-creates the reference halfcheetah benchmark (reference:
autompc/benchmarks/halfcheetah.py:249-298): 18-dim state (9 qpos + 9
qvel), 6 torque controls, 200 steps, metric ``200 - R`` with the gym
running reward. The reference delegates the dynamics to MuJoCo's C
engine through mujoco_py (halfcheetah.py:187-202) and treats it as a
black-box oracle; here the oracle is a **from-scratch planar
articulated-body simulator in jax**:

* Exact multibody dynamics via the autodiff Lagrangian method: body COM
  positions/orientations are forward kinematics ``p_i(q)``; the mass
  matrix and bias forces derive from the kinetic energy through
  ``jax.jacfwd`` (no hand-written recursive dynamics), so the whole
  step is one traced program that fuses into rollout scans and is
  exactly differentiable for `pred_diff`-style use.
* Soft ground contacts at the feet and torso endpoints, solved at the
  velocity level: projected Gauss-Seidel on the friction-cone
  complementarity problem over the Delassus operator, with MuJoCo-style
  compliance (CFM) and Baumgarte push-out — inelastic Coulomb contacts
  like the gym model's, not a penalty spring.
* Linearly-implicit Euler at dt=0.002 with 25 substeps per control
  step (frame-skip semantics of halfcheetah.py:28-43; env dt = 0.05).

Generalized coordinates (gym ordering): ``[rootx, rootz, rooty,
bthigh, bshin, bfoot, fthigh, fshin, ffoot]``. Link parameters
approximate the gym MJCF's geometry/masses; the benchmark contract (like
the reference's) is a fixed plausible oracle, not MuJoCo bit-parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.system import System
from ..core.task import Task
from ..costs.cost import Cost
from . import data_generation as dg
from .benchmark import Benchmark

# ---------------------------------------------------------------------------
# Model parameters (approximating the gym half_cheetah.xml)
# ---------------------------------------------------------------------------

# Per-link: mass, rod inertia about COM, length.
_TORSO_M, _TORSO_I, _TORSO_L = 6.25, 0.3, 1.0
_LINKS = {
    # name: (mass, length)
    "bthigh": (1.54, 0.29),
    "bshin": (1.59, 0.30),
    "bfoot": (1.10, 0.188),
    "fthigh": (1.44, 0.266),
    "fshin": (1.20, 0.212),
    "ffoot": (0.88, 0.14),
}
_GEARS = jnp.array([120.0, 90.0, 60.0, 120.0, 60.0, 30.0])
_DAMPING = jnp.array([6.0, 4.5, 3.0, 4.5, 3.0, 1.5])
_STIFFNESS = jnp.array([240.0, 180.0, 120.0, 180.0, 120.0, 60.0])
# Joint spring reference angles (MJCF springref ~ 0 for all).
_JNT_RANGE = jnp.array(
    [[-0.52, 1.05], [-0.785, 0.785], [-0.4, 0.785],
     [-1.0, 0.7], [-1.2, 0.87], [-0.5, 0.5]]
)
_GRAVITY = 9.81
# Contact friction and rotor armature follow the gym MJCF
# (half_cheetah.xml: geom friction ".4 .1 .1" on both floor and feet;
# default <joint armature=".1"> on the 6 actuated joints, roots 0).
# Measured against real MuJoCo 3.10 with identical seeded controls
# (tools/check_cheetah_vs_mujoco.py, 16 episodes x 100 steps): these
# values cut the median one-step prediction error from 0.63 -> 0.39
# (qpos) and 0.52 -> 0.30 (qvel, relative to the median per-step
# displacement) vs the previous mu=0.8/no-armature oracle, and 100-step
# open-loop divergence from 3.71 -> 3.22.
_FRICTION_MU = 0.4
_ARMATURE = 0.1
# Velocity-level contact solve (MuJoCo-style soft constraint):
_CONTACT_BETA = 0.2        # Baumgarte penetration push-out fraction/step
_CONTACT_PUSH_MAX = 0.5    # cap on push-out velocity (m/s)
_CONTACT_SOFT_N = 2e-3     # normal-constraint compliance (CFM)
_CONTACT_SOFT_T = 1e-3     # tangential compliance
_CONTACT_MARGIN = 1e-4     # activation distance (m)
_PGS_SWEEPS = 8
_SUBSTEPS = 25
_SUB_DT = 0.002

_MASSES = jnp.array(
    [_TORSO_M] + [m for m, _ in _LINKS.values()]
)
_LENGTHS = {k: l for k, (_, l) in _LINKS.items()}
_INERTIAS = jnp.array(
    [_TORSO_I]
    + [m * l * l / 12.0 for m, l in _LINKS.values()]
)


def _body_frames(q):
    """Forward kinematics: returns COM positions (7, 2), orientations
    (7,), and contact points (4, 2) [bfoot tip, ffoot tip, torso rear,
    torso front]."""
    x, z, th = q[0], q[1], q[2]
    q_bt, q_bs, q_bf = q[3], q[4], q[5]
    q_ft, q_fs, q_ff = q[6], q[7], q[8]

    def rot(a):
        c, s = jnp.cos(a), jnp.sin(a)
        return jnp.array([[c, -s], [s, c]])

    root = jnp.array([x, z])
    Rt = rot(th)
    torso_com = root
    rear = root + Rt @ jnp.array([-_TORSO_L / 2, 0.0])
    front = root + Rt @ jnp.array([_TORSO_L / 2, 0.0])

    def chain(origin, base_angle, joints, lengths):
        """Serial chain hanging from origin; returns per-link
        (com, angle) plus the chain tip."""
        coms, angles = [], []
        pos = origin
        ang = base_angle
        for qj, L in zip(joints, lengths):
            ang = ang + qj
            R = rot(ang)
            tip = pos + R @ jnp.array([0.0, -L])
            coms.append((pos + tip) / 2)
            angles.append(ang)
            pos = tip
        return coms, angles, pos

    b_coms, b_angs, b_tip = chain(
        rear, th,
        [q_bt, q_bs, q_bf],
        [_LENGTHS["bthigh"], _LENGTHS["bshin"], _LENGTHS["bfoot"]],
    )
    f_coms, f_angs, f_tip = chain(
        front, th,
        [q_ft, q_fs, q_ff],
        [_LENGTHS["fthigh"], _LENGTHS["fshin"], _LENGTHS["ffoot"]],
    )

    coms = jnp.stack([torso_com] + b_coms + f_coms)
    angles = jnp.stack([th] + b_angs + f_angs)
    contacts = jnp.stack([b_tip, f_tip, rear, front])
    return coms, angles, contacts


def _mass_matrix(q):
    """M(q) = sum_i m_i Jp_i' Jp_i + I_i Jphi_i' Jphi_i via jacfwd
    (+ per-joint rotor armature on the actuated diagonal)."""
    Jp = jax.jacfwd(lambda qq: _body_frames(qq)[0])(q)      # (7, 2, 9)
    Jphi = jax.jacfwd(lambda qq: _body_frames(qq)[1])(q)    # (7, 9)
    M = jnp.einsum("i,iaj,iak->jk", _MASSES, Jp, Jp)
    M = M + jnp.einsum("i,ij,ik->jk", _INERTIAS, Jphi, Jphi)
    if _ARMATURE:
        M = M + jnp.diag(
            jnp.concatenate([jnp.zeros(3), jnp.full(6, _ARMATURE)])
        )
    return M


def _potential(q):
    coms, _, _ = _body_frames(q)
    return _GRAVITY * jnp.sum(_MASSES * coms[:, 1])


def _contact_impulse(q, qdot_unc, A):
    """Velocity-level soft-contact impulse solve (projected Gauss-Seidel
    on the friction-cone complementarity problem), MuJoCo-style.

    Given the unconstrained end-of-substep velocity ``qdot_unc`` and the
    implicit-step effective mass ``A = M + dt D + dt^2 K``, finds contact
    impulses ``lam`` (per contact: tangential, normal) such that

        vn' = vn + (W lam)_n >= b_n   with  lam_n >= 0   (complementary)
        |lam_t| <= mu lam_n,  driving vt' -> 0 (stick) else sliding at
        the cone boundary,

    where ``W = Jc A^-1 Jc'`` is the Delassus operator and ``b_n`` a
    Baumgarte push-out velocity for existing penetration. The soft
    (CFM) terms make the constraint compliant rather than rigid — the
    velocity-impulse analog of MuJoCo's soft-constraint solver, which
    the reference's oracle uses (gym half_cheetah via mujoco_py,
    reference halfcheetah.py:187-202). Inelastic (zero restitution),
    like the gym model. Branch-free (clips + masks), so the whole
    dynamics stays exactly differentiable for pred_diff-style use.

    Returns the generalized velocity correction ``A^-1 Jc' lam``.
    """
    contacts = lambda qq: _body_frames(qq)[2]
    pts = contacts(q)                                 # (4, 2)
    Jc = jax.jacfwd(contacts)(q)                      # (4, 2, 9)
    nC = pts.shape[0]
    Jf = Jc.reshape(2 * nC, 9)                        # rows: (t, n) per contact
    Minv_Jt = jnp.linalg.solve(A, Jf.T)               # (9, 2nC)
    W = Jf @ Minv_Jt                                  # (2nC, 2nC)
    v0 = Jf @ qdot_unc                                # (2nC,)

    pen = jnp.maximum(-pts[:, 1], 0.0)
    active = pts[:, 1] < _CONTACT_MARGIN              # (4,)
    # Push-out target: recover a fraction of the penetration per substep
    # (positive = upward separating velocity; vn' is driven to >= b_n).
    b_n = jnp.minimum(
        _CONTACT_BETA * pen / _SUB_DT, _CONTACT_PUSH_MAX
    )

    t_idx = jnp.arange(nC) * 2
    n_idx = t_idx + 1
    soft = jnp.zeros(2 * nC).at[t_idx].set(_CONTACT_SOFT_T)
    soft = soft.at[n_idx].set(_CONTACT_SOFT_N)
    diagW = jnp.diagonal(W) + soft / _SUB_DT

    def sweep(_, lam):
        # Normal then tangent per contact, full velocity coupling via W.
        for i in range(nC):
            ni, ti = 2 * i + 1, 2 * i
            vn = v0[ni] + W[ni] @ lam
            ln = lam[ni] - (vn - b_n[i] + soft[ni] / _SUB_DT * lam[ni]) / diagW[ni]
            ln = jnp.maximum(ln, 0.0) * active[i]
            lam = lam.at[ni].set(ln)
            vt = v0[ti] + W[ti] @ lam
            lt = lam[ti] - (vt + soft[ti] / _SUB_DT * lam[ti]) / diagW[ti]
            lim = _FRICTION_MU * ln
            lt = jnp.clip(lt, -lim, lim) * active[i]
            lam = lam.at[ti].set(lt)
        return lam

    lam = jax.lax.fori_loop(
        0, _PGS_SWEEPS, sweep, jnp.zeros(2 * nC), unroll=True
    )
    return Minv_Jt @ lam


def _substep(q, qdot, u):
    """One linearly-implicit Euler substep.

    Joint stiffness, range penalties, and damping are handled
    *implicitly* — the MJCF's spring constants (240 N m/rad on inertias
    of ~0.01 kg m^2) put the joint natural frequencies far above what an
    explicit integrator tolerates at this step size, the same reason
    MuJoCo defaults to its implicit-in-velocity solver. Solving

        (M + dt D + dt^2 K) qdot' = M qdot + dt (tau_explicit - K q_err)

    (with K, D diagonal over the actuated joints) makes the stiff modes
    unconditionally stable while everything else stays explicit.
    """
    M = _mass_matrix(q)
    # Bias (Coriolis/centrifugal): c = Mdot qd - 1/2 d/dq (qd' M qd).
    dM = jax.jacfwd(_mass_matrix)(q)                 # (9, 9, 9) dM/dq_k
    Mdot = jnp.einsum("jkl,l->jk", dM, qdot)
    quad = 0.5 * jnp.einsum("jkl,j,k->l", dM, qdot, qdot)
    c = Mdot @ qdot - quad
    g = jax.grad(_potential)(q)
    tau_act = jnp.concatenate([jnp.zeros(3), _GEARS * u])

    # Joint spring/range forces at the current q plus implicit stiffness.
    qj = q[3:]
    below = jnp.minimum(qj - _JNT_RANGE[:, 0], 0.0)
    above = jnp.maximum(qj - _JNT_RANGE[:, 1], 0.0)
    violated = (below < 0) | (above > 0)
    k_joint = _STIFFNESS + 2000.0 * violated
    d_joint = _DAMPING + 20.0 * violated
    tau_spring = -_STIFFNESS * qj - 2000.0 * (below + above)
    tau_spring = jnp.concatenate([jnp.zeros(3), tau_spring])

    K_full = jnp.concatenate([jnp.zeros(3), k_joint])
    D_full = jnp.concatenate([jnp.zeros(3), d_joint])

    rhs = M @ qdot + _SUB_DT * (tau_act + tau_spring - c - g)
    A = M + _SUB_DT * jnp.diag(D_full) + _SUB_DT**2 * jnp.diag(K_full)
    qdot_unc = jnp.linalg.solve(A, rhs)
    qdot_new = qdot_unc + _contact_impulse(q, qdot_unc, A)
    # Clamp velocities for numerical robustness under wild random inputs.
    qdot_new = jnp.clip(qdot_new, -50.0, 50.0)
    q_new = q + _SUB_DT * qdot_new
    return q_new, qdot_new


def halfcheetah_dynamics(x, u, n_frames=_SUBSTEPS):
    """Discrete dynamics: x = [qpos(9), qvel(9)], u in [-1, 1]^6.
    Matches the reference's frame-skip stepping (halfcheetah.py:28-43)."""
    q, qdot = x[:9], x[9:]
    u = jnp.clip(u, -1.0, 1.0)

    def body(carry, _):
        q, qdot = carry
        return _substep(q, qdot, u), None

    (q, qdot), _ = jax.lax.scan(body, (q, qdot), None, length=n_frames)
    return jnp.concatenate([q, qdot])


class HalfcheetahCost(Cost):
    """``200 - R`` with the gym running reward: per step,
    ``-0.1 ||u||^2 + (x_{t+1} - x_t) / dt`` (halfcheetah.py:213-228).

    The running reward telescopes — ``sum_t (x_{t+1,0} - x_{t,0})/dt =
    (x_{T,0} - x_{0,0})/dt`` — so the metric also has an exact
    stage/terminal decomposition: zero obs stage cost, ``0.1 ||u||^2``
    control stage cost, and terminal ``200 - (x_T[0] - init_x)/dt``.
    That form makes the cost usable by sampling/gradient controllers
    (MPPI optimizes the true metric directly) and by the tuning
    fan-outs, which evaluate trajectory cost as
    ``sum eval_obs + sum eval_ctrl + eval_term``.
    """

    def __init__(self, system, dt=0.05, init_x=0.0):
        super().__init__(system)
        self._dt = dt
        self._init_x = float(init_x)
        self._is_quad = False
        self._is_convex = False
        self._is_diff = True
        self._is_twice_diff = True
        self._has_goal = False

    def __call__(self, traj):
        ctrl_r = -0.1 * jnp.sum(traj.ctrls[:-1] ** 2)
        run_r = jnp.sum(traj.obs[1:, 0] - traj.obs[:-1, 0]) / self._dt
        return 200.0 - (ctrl_r + run_r)

    # -- telescoped stage/terminal decomposition -----------------------
    def eval_obs_cost(self, obs):
        return jnp.zeros(())

    def eval_ctrl_cost(self, ctrl):
        return 0.1 * ctrl @ ctrl

    def eval_term_obs_cost(self, obs):
        return 200.0 - (obs[0] - self._init_x) / self._dt


class HalfcheetahBenchmark(Benchmark):
    """18 obs / 6 ctrl, 200 steps, metric 200 - R
    (halfcheetah.py:249-298)."""

    def __init__(self, data_gen_method="uniform_random"):
        system = System(
            [f"x{i}" for i in range(18)], [f"u{i}" for i in range(6)], dt=0.05
        )
        cost = HalfcheetahCost(system, dt=0.05)
        task = Task(system)
        task.set_cost(cost)
        task.set_ctrl_bounds(-np.ones(6), np.ones(6))
        init_qpos = np.zeros(9)
        init_qpos[1] = 0.7  # torso height above ground
        task.set_init_obs(np.concatenate([init_qpos, np.zeros(9)]))
        task.set_num_steps(200)
        super().__init__("halfcheetah", system, task, data_gen_method)

    def dynamics(self, x, u):
        return halfcheetah_dynamics(jnp.asarray(x), jnp.asarray(u))

    def get_cached_tune_result(self):
        """Load the shipped tune-result asset (the halfcheetah analog of
        the reference's cached cartpole tune, cartpole_v2.py:146-153;
        generated by tools/gen_cached_tunes.py halfcheetah)."""
        import os

        from ..utils.checkpoint import load_checkpoint

        path = os.path.join(
            os.path.dirname(__file__),
            "../../assets/cached_tunes/halfcheetah_tune_result.ckpt",
        )
        return load_checkpoint(path)

    def _gen_trajs(self, n_trajs, traj_len, rng):
        init = np.asarray(self.task.get_init_obs())
        # Small random perturbations of the nominal standing pose
        # (analog of gym's reset noise).
        init_min = init - 0.1
        init_max = init + 0.1
        init_min[1] = init[1]
        init_max[1] = init[1] + 0.05
        common = dict(
            system=self.system, task=self.task, dynamics=self.dynamics,
            rng=rng, init_min=init_min, init_max=init_max,
            traj_len=traj_len, n_trajs=n_trajs,
        )
        if self._data_gen_method == "uniform_random":
            return dg.uniform_random_generate_batch(**common)
        elif self._data_gen_method == "multisine":
            return dg.multisine_generate_batch(n_freqs=20, **common)
        elif self._data_gen_method == "random_walk":
            return dg.random_walk_generate_batch(walk_rate=1.0, **common)
        raise ValueError(f"Unknown data_gen_method {self._data_gen_method}")

    def gen_trajs(self, seed, n_trajs, traj_len=200):
        return self.gen_trajs_batch(seed, n_trajs, traj_len).to_list()

    def gen_trajs_batch(self, seed, n_trajs, traj_len=200):
        rng = np.random.default_rng(seed)
        return self._gen_trajs(n_trajs, traj_len, rng)

    def visualize(self, fig, ax, traj, repeat=1):
        """Matplotlib stick-figure animation of the planar cheetah
        (replaces the reference's gym render loop,
        halfcheetah.py:16-26)."""
        import matplotlib.animation as animation

        obs = np.asarray(traj.obs)

        ax.axhline(0.0, color="k", lw=1)
        ax.set_xlim(obs[:, 0].min() - 1.5, obs[:, 0].max() + 1.5)
        ax.set_ylim(-0.5, 2.0)
        ax.set_aspect("equal")
        (torso_line,) = ax.plot([], [], "o-", lw=3)
        (bleg_line,) = ax.plot([], [], "o-", lw=2)
        (fleg_line,) = ax.plot([], [], "o-", lw=2)

        def frame(i):
            i = min(i % (traj.size * repeat), traj.size - 1)
            q = jnp.asarray(obs[i, :9])
            coms, _, contacts = _body_frames(q)
            rear = np.asarray(contacts[2])
            front = np.asarray(contacts[3])
            torso_line.set_data([rear[0], front[0]], [rear[1], front[1]])

            # Reconstruct leg chains from link COMs (each COM is the
            # midpoint of its segment).
            def chain_pts(origin, com_list):
                pts = [np.asarray(origin)]
                for c in com_list:
                    tip = 2 * np.asarray(c) - pts[-1]
                    pts.append(tip)
                return np.array(pts)

            bp = chain_pts(rear, [coms[1], coms[2], coms[3]])
            fp = chain_pts(front, [coms[4], coms[5], coms[6]])
            bleg_line.set_data(bp[:, 0], bp[:, 1])
            fleg_line.set_data(fp[:, 0], fp[:, 1])
            return torso_line, bleg_line, fleg_line

        return animation.FuncAnimation(
            fig, frame, frames=traj.size * repeat,
            interval=self.system.dt * 1000, blit=True,
        )

    @staticmethod
    def data_gen_methods():
        return ["uniform_random", "multisine", "random_walk"]
