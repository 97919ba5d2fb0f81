"""EnvMove05-v1: the hierarchical move stack in the walled corridor (the
reference project's envs/envMove05_v1.py, its base RobotMoveBaseEnv.py and
envMove05_v1.xml:30-41), stepped by the plain physics of the 8-dof scene
with four static walls.

The outer policy's action (B, 2) in [-1, 1] commands a target wheel speed
(x 20) and yaw (x 45). One control step: the reward from the pre-step state
(speed tracking plus the clearance of lidar rays 2..5); the commanded
targets and the finite-difference pitch_dot recorded; the frozen int8 inner
policy (`reference/quant.py`) on its float32 obs [pitch / 0.25, pitch_dot,
vel_l / 170 x 4, vel_r / 170 x 4, (target speed - wheel speed) / 170 x 4,
(target yaw - wheel yaw) / 45 x 3] sets the servo targets (wheel qvel +
action x 4); 250 substeps; termination at |pitch| > 50 deg; truncation at
700 steps; the outer obs (B, 10) float32 [wheel speed / 170, wheel yaw /
45, 8 lidar slots]. The step draws no noise (`n_uniforms` 0).

Departures from the reference project, each as the port has it:
  * the outer obs's 8 lidar slots are zero, the reference's as-built
    behavior (RobotMoveBaseEnv.py:347-359); the reward reads the real rays;
  * the lidar's `front_indicator` body is in no shipped XML: the sensor
    frame is the chassis frame raised 0.110 m (the height the reference's
    pitch correction assumes), and the rays meet only the static scene (the
    floor plane and the four walls), not the robot itself;
  * the reset's chassis quaternion is scipy's [x, y, z, w] written raw into
    MuJoCo's [w, x, y, z] slots, the reference's quirk, kept;
  * time is float32 (t x 5 ms), as the reference's MuJoCo time read back as
    float32 is.
"""

import math
from pathlib import Path

import numpy as np
import torch

from . import (CONTROL_DT, PITCH_DOT_MAX, PITCH_MAX, TERMINATE_PITCH,
               WHEEL_SPEED_DELTA_MAX, WHEEL_SPEED_MAX, YAW_MAX,
               bfloat16_state, pitch_of)
from .. import quant
from ..physics import robot_core as rc, step as ps, with_grade
from ..physics.slin import qmat

# envMove05_v1.xml:30-41, the corridor: (centre), (half-extents) of each wall
WALLS = (
    ((0.25, 0.0, -0.025), (0.01, 1.0, 0.2)),
    ((-0.25, 0.0, -0.025), (0.01, 1.0, 0.2)),
    ((0.0, 1.0, -0.025), (1.0, 0.01, 0.2)),
    ((0.0, -1.0, -0.025), (1.0, 0.01, 0.2)),
)
# RobotMoveBaseEnv.py:71-79: 8 rays from -50 deg in steps of 14.285 deg
# about the sensor's z, each Rz(angle) @ (0, 1, 0)
RAY_ANGLES = [math.radians(a) for a in np.arange(-50, 50.1, 14.285)]
LIDAR_RANGE = 0.3
LIDAR_HEIGHT = 0.110
WHEEL_RADIUS = 0.034
FLOOR_Z = -0.02
SPEED_SCALE = 20.0
# the artifact the port packages (the config's `inner_policy`)
INNER_POLICY = (Path(__file__).resolve().parents[3] / "balance_robot_tpu_torch"
                / "envs" / "assets" / "inner_policy.brq.npz")


def safe(x, eps):
    """x, with |x| < eps replaced by +eps."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def ray_distances(origin, dirs):
    """(B, 8) distance along each ray (origin (B, 3), dirs (B, 8, 3)) to
    the floor plane or a wall box, the nearest; inf where it meets none; a
    ray that starts inside a box reports where it leaves it."""
    inf = torch.full_like(dirs[..., 0], math.inf)
    dz = dirs[..., 2]
    t = (FLOOR_Z - origin[:, None, 2]) / safe(dz, 1e-12)
    best = torch.where((dz.abs() > 1e-12) & (t > 0), t, inf)
    inv = 1.0 / safe(dirs, 1e-12)
    for centre, half in WALLS:
        c = torch.tensor(centre, dtype=dirs.dtype, device=dirs.device)
        h = torch.tensor(half, dtype=dirs.dtype, device=dirs.device)
        t1 = ((c - h) - origin).unsqueeze(1) * inv
        t2 = ((c + h) - origin).unsqueeze(1) * inv
        near = torch.minimum(t1, t2).max(-1).values
        far = torch.maximum(t1, t2).min(-1).values
        hit = (far >= near) & (far > 0)
        t = torch.where(hit, torch.where(near > 0, near, far), inf)
        best = torch.minimum(best, t)
    return best


def lidar(qpos):
    """The 8 readings (B, 8) of RobotMoveBaseEnv.py:212-277: cast from the
    sensor frame; beyond the range -> 0; a reading at or past where a ray
    of the pitched sensor meets the floor -> 0, else x cos(pitch); 0 ->
    the full range; below 0 -> 0."""
    q = qpos[:, 3:7]
    R = qmat(q / q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30))
    origin = qpos[:, 0:3] + R[:, :, 2] * LIDAR_HEIGHT
    local = torch.tensor([(-math.sin(a), math.cos(a), 0.0)
                          for a in RAY_ANGLES], dtype=qpos.dtype,
                         device=qpos.device)
    d = ray_distances(origin, local @ R.transpose(-1, -2))
    d = torch.where(d > LIDAR_RANGE, torch.zeros_like(d), d)
    # the simulated pitch has the opposite sign of the real robot's
    pitch = -pitch_of(qpos)
    floor = (WHEEL_RADIUS / safe(torch.sin(pitch), 1e-9)
             + LIDAR_HEIGHT / safe(torch.tan(pitch), 1e-9)
             - 0.010).unsqueeze(-1)
    d = torch.where((d >= floor) & (floor > 0), torch.zeros_like(d),
                    d * torch.cos(pitch).unsqueeze(-1))
    d = torch.where(d == 0.0, torch.full_like(d, LIDAR_RANGE), d)
    return torch.where(d < 0.0, torch.zeros_like(d), d)


def wheel_speed(qvel):
    return (qvel[:, 6] - qvel[:, 7]) / 2.0


def wheel_yaw(qvel):
    return qvel[:, 6] + qvel[:, 7]


class EnvMove05V1:
    """Move along the corridor at the commanded speed, clear of the
    walls."""

    id = "EnvMove05-v1"
    nq, nv, n_uniforms = 9, 8, 0
    max_episode_steps = 700
    reset_jitter = 0.01

    def __init__(self, solver):
        # a float32 product on the card may otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = with_grade(rc.RobotSceneParams(walls=WALLS), solver)
        self.inner = quant.load(INNER_POLICY)

    def physics(self, qpos, qvel, ws, ctrl, frame_skip=250):
        if qpos.dtype == torch.bfloat16:
            return bfloat16_state(self.physics, qpos, qvel, ws, ctrl)
        s = ps.control_step(ps.PhysState(qpos, qvel, ws), ctrl, self.params,
                            frame_skip=frame_skip)
        return s.qpos, s.qvel, s.warmstart

    def reward(self, state):
        """envMove05_v1.py:103-116, from the pre-step state."""
        ws, tws = wheel_speed(state["qvel"]), state["target_wheel_speed"]
        reward = 0.5 + 0.03 * (ws - tws) / tws
        d = lidar(state["qpos"])
        for i in range(2, 6):
            reward = reward + 0.15 * (d[:, i] - 0.15) / 0.3
        return reward

    def inner_obs(self, state, target_speed, target_yaw):
        """(inner obs (B, 6) float32, the fd pitch_dot slots after it)."""
        qpos, qvel = state["qpos"], state["qvel"]
        pitch = pitch_of(qpos)
        t = state["t"].to(torch.float32) * CONTROL_DT
        dt = t - state["last_t"]
        ok = state["has_last"] & (dt > 0.0)
        pd = torch.where(ok, (pitch - state["last_pitch"])
                         / torch.where(ok, dt, torch.ones_like(dt)),
                         torch.zeros_like(pitch))
        vel_l, vel_r = qvel[:, 6], qvel[:, 7]
        obs = torch.stack([
            pitch / PITCH_MAX,
            pd / PITCH_DOT_MAX,
            vel_l / WHEEL_SPEED_MAX * 4.0,
            vel_r / WHEEL_SPEED_MAX * 4.0,
            (target_speed - wheel_speed(qvel)) / WHEEL_SPEED_MAX * 4.0,
            (target_yaw - wheel_yaw(qvel)) / YAW_MAX * 3.0], -1)
        slots = dict(last_pitch=pitch, last_t=t,
                     has_last=torch.ones_like(state["has_last"]))
        return obs.to(torch.float32), slots

    def ctrl(self, state, action):
        """(servo targets (B, 2), the state with the commanded targets and
        the fd slots recorded)."""
        speed = action[:, 0] * SPEED_SCALE
        yaw = action[:, 1] * YAW_MAX
        obs, slots = self.inner_obs(state, speed, yaw)
        inner = quant.act(self.inner, obs).to(state["qvel"].dtype)
        ctrl = state["qvel"][:, 6:8] + inner * WHEEL_SPEED_DELTA_MAX
        return ctrl, dict(state, target_wheel_speed=speed,
                          target_yaw=yaw, **slots)

    def observe(self, qvel):
        obs = torch.zeros((qvel.shape[0], 10), dtype=torch.float32,
                          device=qvel.device)
        obs[:, 0] = (wheel_speed(qvel) / WHEEL_SPEED_MAX).to(torch.float32)
        obs[:, 1] = (wheel_yaw(qvel) / YAW_MAX).to(torch.float32)
        return obs

    def step(self, state, action, u, phys=None):
        """One control step from `state` under `action` (`u` is empty).
        `phys` = (qpos', qvel', ws') stands in for the physics when given.
        Returns (state', obs, reward, terminated, truncated, margin): margin
        is how far each env's termination decision lies from its threshold
        (radians)."""
        reward = self.reward(state)
        ctrl, state = self.ctrl(state, action)
        if phys is None:
            phys = self.physics(state["qpos"], state["qvel"], state["ws"],
                                ctrl)
        post = dict(state, qpos=phys[0], qvel=phys[1], ws=phys[2],
                    t=state["t"] + 1)
        pitch = pitch_of(post["qpos"]).abs()
        terminated = pitch > TERMINATE_PITCH
        truncated = post["t"] >= self.max_episode_steps
        margin = (pitch - TERMINATE_PITCH).abs()
        return (post, self.observe(post["qvel"]), reward, terminated,
                truncated, margin)

    def fresh(self, s, obs):
        """(B,) bool: whether each env of state dict `s` with obs `obs` is
        a fresh episode as the reset makes it: qpos jittered by +-0.01 with
        z at 0, the chassis turned by a scrambled euler quaternion (x any,
        y and z within +-0.2 rad), zero velocities and warm start, target
        speed in [31, 40], target yaw 0, the fd pitch_dot state empty, the
        obs zero."""
        q, j = s["qpos"], self.reset_jitter + 1e-6
        # the scrambled slots hold [x, y, z, w] of a proper quaternion
        p = torch.cat((q[:, 6:7], q[:, 3:6]), -1)
        R = qmat(p / p.square().sum(-1, keepdim=True).sqrt().clamp_min(
            1e-30))
        y_rot = torch.asin(-R[:, 2, 0].clamp(-1.0, 1.0))
        z_rot = torch.atan2(R[:, 1, 0], R[:, 0, 0])
        tws = s["target_wheel_speed"]
        return ((s["t"] == 0) & (s["qvel"] == 0).all(-1)
                & (s["ws"] == 0).all(-1)
                & (q[:, 0:2].abs() <= j).all(-1) & (q[:, 2] == 0)
                & (q[:, 7:9].abs() <= j).all(-1)
                & ((q[:, 3:7].square().sum(-1) - 1).abs() <= 1e-5)
                & (y_rot.abs() <= 0.2 + 1e-5) & (z_rot.abs() <= 0.2 + 1e-5)
                & (s["last_t"] == 0) & (s["last_pitch"] == 0)
                & ~s["has_last"]
                & (tws >= 31.0 - 1e-5) & (tws <= 40.0 + 1e-5)
                & (s["target_yaw"] == 0) & (obs == 0).all(-1))


ENV = EnvMove05V1
