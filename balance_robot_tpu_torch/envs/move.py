"""Hierarchical move stack: EnvMove05-v1, batch-first.

Counterpart of `balance_robot_tpu/envs/move.py`. The trained (outer) policy
commands [target_speed, target_yaw]; the 200 Hz balancing is done inside
`step` by a frozen int8 policy, a `.brq` artifact run by `ops/quant.py` for
all B envs at once. The robot moves in a corridor of four static walls;
its physics is the wall scene of `physics/step.py` (kernel K3 on CUDA
tensors).

Lidar: 8 rays at -50..50 deg (step 14.285) about z of the sensor frame,
which is the chassis frame at height 0.110, cast against the floor plane
and the walls, with the reference's pitch correction and range rules. The
outer obs keeps the reference's as-built zeroed lidar slots, while the
reward uses the real ray distances.
"""

import pathlib

import numpy as np
import torch

from ..export.pipeline import load_brq
from ..ops import quant
from ..physics import robot_core as rc
from ..physics.cuda_step import control_step
from ..physics.slin import qmat
from ..physics.step import PhysState
from . import base
from .base import (EnvState, WHEEL_SPEED_DELTA_MAX, TERMINATE_PITCH,
                   pitch_of, scipy_euler_to_mj_quat_scrambled)
from .env01 import Env01V1

# envMove05_v1.xml corridor walls ((center), (half-extents))
WALLS = (
    ((0.25, 0.0, -0.025), (0.01, 1.0, 0.2)),
    ((-0.25, 0.0, -0.025), (0.01, 1.0, 0.2)),
    ((0.0, 1.0, -0.025), (1.0, 0.01, 0.2)),
    ((0.0, -1.0, -0.025), (1.0, 0.01, 0.2)),
)

MOVE05_PARAMS = rc.RobotSceneParams(walls=WALLS)

RAY_ANGLES = np.arange(-50, 50.1, 14.285) * (np.pi / 180.0)   # 8 rays
LIDAR_RANGE = 0.3
LIDAR_HEIGHT = 0.110
WHEEL_RADIUS = 0.034
FLOOR_Z = -0.02

# Rz(a) @ (0, 1, 0) for each ray angle
RAY_DIRS_LOCAL = np.asarray([(-np.sin(a), np.cos(a), 0.0)
                             for a in RAY_ANGLES])

INNER_POLICY_ASSET = (pathlib.Path(__file__).parent / "assets"
                      / "inner_policy.brq.npz")


def _away_from_zero(x, eps):
    """x, with |x| < eps replaced by +eps (a safe divisor)."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def raycast(origin, dirs):
    """Distances to the nearest static geom (floor plane + walls), per ray.

    origin (B, 3), dirs (B, 8, 3) world. Returns (B, 8) distances: inf when
    a ray hits nothing, the exit distance when it starts inside a box."""
    inf = torch.full_like(dirs[..., 0], torch.inf)
    dz = dirs[..., 2]
    t_floor = (FLOOR_Z - origin[:, None, 2]) / _away_from_zero(dz, 1e-12)
    t_all = [torch.where((dz.abs() > 1e-12) & (t_floor > 0), t_floor, inf)]
    inv = 1.0 / _away_from_zero(dirs, 1e-12)
    for center, half in WALLS:
        c = torch.tensor(center, dtype=dirs.dtype, device=dirs.device)
        h = torch.tensor(half, dtype=dirs.dtype, device=dirs.device)
        t1 = ((c - h) - origin).unsqueeze(1) * inv
        t2 = ((c + h) - origin).unsqueeze(1) * inv
        tmin = torch.minimum(t1, t2).max(-1).values
        tmax = torch.maximum(t1, t2).min(-1).values
        hit = (tmax >= tmin) & (tmax > 0)
        t = torch.where(tmin > 0, tmin, tmax)
        t_all.append(torch.where(hit, t, inf))
    return torch.stack(t_all).min(0).values


def lidar_distances(qpos):
    """The 8 lidar readings (B, 8) of qpos (B, 9): ray casts from the sensor
    frame, then, in this order, the range limit, the floor-hit rejection
    with the cos(pitch) correction, and no-hit -> full range."""
    q = qpos[:, 3:7]
    n = q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30)
    R = qmat(q / n)
    origin = qpos[:, 0:3] + R[:, :, 2] * LIDAR_HEIGHT
    local = torch.tensor(RAY_DIRS_LOCAL, dtype=qpos.dtype, device=qpos.device)
    dirs = local @ R.transpose(-1, -2)
    dist = raycast(origin, dirs)
    dist = torch.where(dist > LIDAR_RANGE, torch.zeros_like(dist), dist)
    # the simulated pitch is opposite to the real robot's
    pitch = -pitch_of(qpos)
    floor_distance = (WHEEL_RADIUS / _away_from_zero(torch.sin(pitch), 1e-9)
                      + LIDAR_HEIGHT / _away_from_zero(torch.tan(pitch), 1e-9)
                      - 0.010).unsqueeze(-1)
    hit_floor = (dist >= floor_distance) & (floor_distance > 0)
    dist = torch.where(hit_floor, torch.zeros_like(dist),
                       dist * torch.cos(pitch).unsqueeze(-1))
    dist = torch.where(dist == 0.0, torch.full_like(dist, LIDAR_RANGE), dist)
    return torch.where(dist < 0.0, torch.zeros_like(dist), dist)


class EnvMove05(Env01V1):
    """EnvMove05-v1 (reference envMove05_v1.py): the outer policy sets the
    target speed and yaw, reward = speed tracking + wall clearance on rays
    2..5."""

    id = "EnvMove05-v1"
    obs_dim = 10
    act_dim = 2
    max_episode_steps = 700
    reward_threshold = 900.0
    params = MOVE05_PARAMS

    def __init__(self, device=None, dtype=torch.float32, seed=0,
                 inner_policy=None):
        """inner_policy: a QuantizedMLP; by default the packaged artifact."""
        super().__init__(device=device, dtype=dtype, seed=seed)
        self.inner = (load_brq(INNER_POLICY_ASSET) if inner_policy is None
                      else inner_policy)
        self._inner_fn = quant.int8_policy_fn(self.inner, self.device)

    def reset(self, n):
        """n fresh episodes: (EnvState, obs (n, 10) float32). The target
        speed is U(1, 10) + 30; the fd pitch_dot state starts empty (the
        first step's inner obs reads pitch_dot = 0)."""
        u = self._uniform(n, 13)
        qpos = self._zeros((n, 9))
        qpos[:, 3] = 1.0
        qpos = qpos + (u[:, :9] * 0.02 - 0.01)
        qpos[:, 2] = 0.0
        x_rot = (u[:, 9] - 0.5) * 2 * torch.pi
        y_rot = (u[:, 10] - 0.5) * 0.4
        z_rot = (u[:, 11] - 0.5) * 0.4
        qpos[:, 3:7] = scipy_euler_to_mj_quat_scrambled(x_rot, y_rot, z_rot)
        zeros = self._zeros((n, 8))
        state = EnvState(
            phys=PhysState(qpos=qpos, qvel=zeros, warmstart=zeros.clone()),
            t=self._zeros(n, torch.int32),
            last_pitch=self._zeros(n), last_t=self._zeros(n, torch.float32),
            has_last=self._zeros(n, torch.bool),
            target_wheel_speed=u[:, 12] * 9.0 + 1.0 + 30.0,
            target_yaw=self._zeros(n), aux={})
        return state, self._obs(state)

    def state_from_qpos(self, qpos, qvel=None, target_wheel_speed=None):
        """EnvState from explicit (qpos (B, 9), qvel (B, 8)) and the target
        speed (B,) the reward divides by -- the parity entry point."""
        state = super().state_from_qpos(qpos, qvel)
        if target_wheel_speed is not None:
            state = state._replace(target_wheel_speed=target_wheel_speed.to(
                self.device, self.dtype))
        return state

    def step(self, state: EnvState, action, uniforms=None):
        """One control step of every env; draws no noise (`uniforms` is
        accepted for VecEnv's signature and ignored).

        action (B, 2) in [-1, 1] = (target speed / 20, target yaw / 45).
        Returns (state, obs float32, reward, terminated, truncated)."""
        # 1) reward from the pre-step state
        reward = self._reward(state)
        # 2) the inner int8 balance policy sets the wheel servos
        state, ctrl = self.wheel_ctrl(state, action)
        phys = PhysState(*control_step(
            state.phys.qpos, state.phys.qvel, state.phys.warmstart, ctrl,
            None, self.params))
        state = state._replace(phys=phys, t=state.t + 1)
        terminated = pitch_of(phys.qpos).abs() > TERMINATE_PITCH
        truncated = state.t >= self.max_episode_steps
        return state, self._obs(state), reward, terminated, truncated

    def wheel_ctrl(self, state, action):
        """(state, ctrl (B, 2)): the servo targets `step` hands the physics
        for the outer `action`. The commanded speed and yaw are scaled in
        the action's own dtype, then widened to the env's."""
        action = action.to(self.device)
        return self._step_wheel_speeds(
            state, (action[:, 0] * 20.0).to(self.dtype),
            (action[:, 1] * base.YAW_MAX).to(self.dtype))

    def _step_wheel_speeds(self, state, target_speed, target_yaw):
        """Record the commanded targets, advance the fd pitch_dot state (the
        only place that does), run the inner policy on its float32 obs and
        return (state, ctrl (B, 2) = wheel qvel + inner action * 4)."""
        state = state._replace(target_wheel_speed=target_speed,
                               target_yaw=target_yaw)
        qpos, qvel = state.phys.qpos, state.phys.qvel
        pitch = pitch_of(qpos)
        pd, lp, lt, hl = base.fd_pitch_dot(state, pitch)
        state = state._replace(last_pitch=lp, last_t=lt, has_last=hl)
        vel_l, vel_r = base.wheel_velocities(qvel)
        inner_obs = torch.stack([
            pitch / base.PITCH_MAX,
            pd / base.PITCH_DOT_MAX,
            vel_l / base.WHEEL_SPEED_MAX * 4.0,
            vel_r / base.WHEEL_SPEED_MAX * 4.0,
            (target_speed - base.wheel_speed(qvel))
            / base.WHEEL_SPEED_MAX * 4.0,
            (target_yaw - base.wheel_yaw(qvel)) / base.YAW_MAX * 3.0,
        ], -1).to(torch.float32)
        inner_action = self._inner_fn(inner_obs)
        ctrl = qvel[:, 6:8] + inner_action.to(self.dtype) \
            * WHEEL_SPEED_DELTA_MAX
        return state, ctrl

    def _reward(self, state):
        ws = base.wheel_speed(state.phys.qvel)
        tws = state.target_wheel_speed
        reward = 0.5 + 0.03 * (ws - tws) / tws
        dists = lidar_distances(state.phys.qpos)
        for i in range(2, 6):
            reward = reward + 0.15 * (dists[:, i] - 0.15) / 0.3
        return reward

    def _obs(self, state):
        """obs (B, 10) float32: wheel speed, wheel yaw, 8 zeroed lidar
        slots. Does not touch the fd pitch_dot state."""
        qvel = state.phys.qvel
        obs = torch.zeros((qvel.shape[0], 10), dtype=torch.float32,
                          device=qvel.device)
        obs[:, 0] = base.wheel_speed(qvel) / base.WHEEL_SPEED_MAX
        obs[:, 1] = base.wheel_yaw(qvel) / base.YAW_MAX
        return obs
