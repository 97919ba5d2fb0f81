"""Env01 family: balance (v1), noisy-obs balance (v2), balance-then-move (v3).

Counterpart of `balance_robot_tpu/envs/env01.py`, batch-first: every method
takes and returns (B, ...) tensors for B envs at once.

Randomness comes from the env's `torch.Generator` on the env's device. A
step of v2 draws 4 uniforms per env, in the JAX package's order: the
reward's pitch noise, the termination pitch noise, then the two noisy
pitch reads of the obs. `step(..., uniforms=...)` takes those draws
explicitly instead, so a caller can replay another stream. Every draw of
every env goes through `_uniform` with the batch first, so that a rank of a
sharded run draws the global batch's uniforms and keeps its own rows.
"""

import torch

from ..device import resolve_device
from ..parallel.mesh import global_draw
from ..physics import fast_solver
from ..physics import robot_core as rc
from ..physics.cuda_step import control_step
from ..physics.step import PhysState
from . import base
from .base import (EnvState, WHEEL_SPEED_DELTA_MAX, TERMINATE_PITCH,
                   base_reward, pitch_of, scipy_euler_to_mj_quat_scrambled)


class Env01V1:
    """Plain balance env (reference env01_v1.py)."""

    id = "Env01-v1"
    obs_dim = 6
    act_dim = 2
    max_episode_steps = 6000
    reward_threshold = 6000.0
    params = rc.ENV01_PARAMS
    # reset euler ranges: x in +-pi, y/z in +-0.2 (env01_v1.py:46-49)
    reset_y_range = 0.2
    reset_z_range = 0.2
    # whether the pitch reads are noisy (v2): 4 uniforms per env and step
    noisy = False
    # (rank, size) on a rank of a sharded run (`train.ppo.shard_env`)
    shard = None

    def __init__(self, device=None, dtype=torch.float32, seed=0):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def use_fast_solver(self):
        """Switch to the training-grade constraint solver (Newton 4 / line
        search 6)."""
        self.params = fast_solver(self.params)
        return self

    def _uniform(self, *shape):
        """Uniforms (batch first) from the env's generator; on a rank of a
        sharded run, its rows of the global batch's draw."""
        return global_draw(lambda s: torch.rand(
            s, generator=self.generator, device=self.device,
            dtype=self.dtype), shape, self.shard)

    def _zeros(self, shape, dtype=None):
        return torch.zeros(shape, device=self.device,
                           dtype=dtype or self.dtype)

    # ---- noise hook (overridden by v2/v3); u is (B,) uniforms
    def _pitch(self, state, qpos, u):
        return pitch_of(qpos)

    def reset(self, n):
        """n fresh episodes: (EnvState, obs (n, 6) float32)."""
        u = self._uniform(n, 12)
        qpos = self._zeros((n, 9))
        qpos[:, 3] = 1.0
        qpos = qpos + (u[:, :9] * 0.02 - 0.01)
        qpos[:, 2] = 0.0
        x_rot = (u[:, 9] - 0.5) * 2 * torch.pi
        y_rot = (u[:, 10] - 0.5) * 2 * self.reset_y_range
        z_rot = (u[:, 11] - 0.5) * 2 * self.reset_z_range
        qpos[:, 3:7] = scipy_euler_to_mj_quat_scrambled(x_rot, y_rot, z_rot)
        zeros = self._zeros((n, 8))
        state = EnvState(
            phys=PhysState(qpos=qpos, qvel=zeros, warmstart=zeros.clone()),
            t=self._zeros(n, torch.int32),
            last_pitch=self._zeros(n), last_t=self._zeros(n, torch.float32),
            has_last=self._zeros(n, torch.bool),
            target_wheel_speed=self._zeros(n), target_yaw=self._zeros(n),
            aux=self._init_aux(n))
        return self._obs(state, self._noise(n, 2))

    def _init_aux(self, n):
        return {}

    def state_from_qpos(self, qpos, qvel=None, aux=None):
        """EnvState from explicit (qpos (B, 9), qvel (B, 8)) and optionally
        the env-specific aux slots -- the parity entry point. Mirrors the
        post-reset bookkeeping: the fd-pitch_dot state is seeded with
        (pitch0, t = 0)."""
        qpos = qpos.to(self.device, self.dtype)
        n = qpos.shape[0]
        qvel = (self._zeros((n, 8)) if qvel is None
                else qvel.to(self.device, self.dtype))
        return EnvState(
            phys=PhysState(qpos=qpos, qvel=qvel,
                           warmstart=self._zeros((n, 8))),
            t=self._zeros(n, torch.int32),
            last_pitch=pitch_of(qpos), last_t=self._zeros(n, torch.float32),
            has_last=torch.ones(n, dtype=torch.bool, device=self.device),
            target_wheel_speed=self._zeros(n), target_yaw=self._zeros(n),
            aux=self._init_aux(n) if aux is None else aux)

    def _update_targets(self, state):
        return state

    def _noise(self, n, k):
        return self._uniform(n, k) if self.noisy else self._zeros((n, k))

    def step(self, state: EnvState, action, uniforms=None):
        """One control step of every env.

        action (B, 2) in [-1, 1]; uniforms (B, 4) replaces the noise draws.
        Returns (state, obs float32, reward, terminated, truncated)."""
        n = action.shape[0]
        u = self._noise(n, 4) if uniforms is None else uniforms.to(
            self.device, self.dtype)
        state = self._update_targets(state)
        qvel = state.phys.qvel
        # 1) reward from the pre-step state
        reward = self._reward(state, u[:, 0])
        # 2) ctrl = wheel qvel + action * 4
        ctrl = qvel[:, 6:8] + action.to(self.device, self.dtype) \
            * WHEEL_SPEED_DELTA_MAX
        # 3) 250 implicitfast substeps
        phys = PhysState(*control_step(
            state.phys.qpos, state.phys.qvel, state.phys.warmstart,
            ctrl, state.aux.get("friction"), self.params))
        state = state._replace(phys=phys, t=state.t + 1)
        # 4) terminate at |pitch| > 50 deg, on a (possibly noisy) sample
        terminated = self._pitch(state, phys.qpos, u[:, 1]).abs() \
            > TERMINATE_PITCH
        # 5) obs from the post-step state
        state, obs = self._obs(state, u[:, 2:])
        truncated = state.t >= self.max_episode_steps
        return state, obs, reward, terminated, truncated

    def _reward(self, state, u):
        return base_reward(state, self._pitch(state, state.phys.qpos, u))

    def _obs(self, state, u):
        """(state with the fd pitch_dot advanced, obs (B, 6) float32);
        u (B, 2) are the noise draws of the two pitch reads."""
        qpos, qvel = state.phys.qpos, state.phys.qvel
        # the reference's _get_obs reads the pitch twice (directly and
        # inside get_pitch_dot_alt): two independent noise draws in v2
        pitch_obs = self._pitch(state, qpos, u[:, 0])
        pitch_fd = self._pitch(state, qpos, u[:, 1])
        pd, lp, lt, hl = base.fd_pitch_dot(state, pitch_fd)
        vel_l, vel_r = base.wheel_velocities(qvel)
        obs = torch.stack([
            pitch_obs / base.PITCH_MAX,
            pd / base.PITCH_DOT_MAX,
            vel_l / base.WHEEL_SPEED_MAX * 4.0,
            vel_r / base.WHEEL_SPEED_MAX * 4.0,
            (state.target_wheel_speed - base.wheel_speed(qvel))
            / base.WHEEL_SPEED_MAX * 4.0,
            (state.target_yaw - base.wheel_yaw(qvel)) / base.YAW_MAX * 3.0,
        ], -1).to(torch.float32)
        state = state._replace(last_pitch=lp, last_t=lt, has_last=hl)
        return state, obs


class Env01V2(Env01V1):
    """Balance with +-0.025 rad uniform pitch noise and a wider reset
    z-rotation (reference env01_v2.py)."""

    id = "Env01-v2"
    reset_y_range = 0.1
    reset_z_range = 1.0
    noisy = True

    def _pitch(self, state, qpos, u):
        return pitch_of(qpos) + (u - 0.5) * 0.05


class Env01V3(Env01V1):
    """Balance then follow a time-scheduled target speed, with a
    per-episode pitch sensor bias (reference env01_v3.py)."""

    id = "Env01-v3"

    def _init_aux(self, n):
        u = self._uniform(n, 2)
        dts = u[:, 0] * 20.0 - 10.0
        dts = torch.where(dts > 0, dts + 10.0, dts - 10.0)
        pitch_offset = u[:, 1] * (2 * 0.0349066) - 0.0349066
        return {"delay_target_speed": dts, "pitch_offset": pitch_offset}

    def _pitch(self, state, qpos, u):
        return pitch_of(qpos) + state.aux["pitch_offset"]

    def _update_targets(self, state):
        # schedule checked on the pre-step time (env01_v3.py:28-36)
        t = base.time_of(state)
        dts = state.aux["delay_target_speed"]
        tw = state.target_wheel_speed
        tw = torch.where(t > 1.0, dts, tw)
        tw = torch.where(t > 3.0, -1.0 * dts, tw)
        tw = torch.where(t > 4.5, 2.0 * dts, tw)
        tw = torch.where(t > 5.5, 3.0 * dts, tw)
        return state._replace(target_wheel_speed=tw)

    def _reward(self, state, u):
        # custom move reward (env01_v3.py:56-96)
        pitch = self._pitch(state, state.phys.qpos, u)
        qvel = state.phys.qvel
        ws = base.wheel_speed(qvel)
        tws = state.target_wheel_speed
        dv = tws - ws
        reward = 0.6 - pitch.abs() * 0.05
        MAX_DV = 40.0
        dv_s = (dv.clamp(-MAX_DV, MAX_DV) / MAX_DV).abs()
        reward = reward - 0.15 * dv_s
        zero = torch.zeros_like(pitch)
        lean = torch.where(
            (tws > 0) & (tws > ws), -pitch * 10.0 * dv_s,
            torch.where((tws < 0) & (tws < ws), pitch * 10.0 * dv_s,
                        torch.where((tws > 0) & (tws < ws),
                                    pitch * 10.0 * dv_s,
                                    torch.where((tws < 0) & (tws > ws),
                                                -pitch * 10.0 * dv_s,
                                                zero))))
        reward = reward + lean
        return reward - 0.007 * (state.target_yaw - base.wheel_yaw(qvel)).abs()
