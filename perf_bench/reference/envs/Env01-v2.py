"""Env01-v2: balance on a flat floor with +-0.025 rad uniform pitch noise
(the reference project's envs/env01_v2.py), stepped by the plain physics of
the 8-dof scene."""

import torch

from . import (TERMINATE_PITCH, WHEEL_SPEED_DELTA_MAX, PITCH_MAX,
               base_reward, bfloat16_state, observe, pitch_of)
from ..physics import robot_core as rc, step as ps, with_grade


class Env01V2:
    """Balance on a flat floor with +-0.025 rad uniform pitch noise."""

    id = "Env01-v2"
    nq, nv, n_uniforms = 9, 8, 4
    max_episode_steps = 6000
    # the reset: qpos jittered by +-0.01 (z set to 0), the chassis turned
    # by a scrambled euler quaternion, zero velocities
    reset_jitter = 0.01

    def __init__(self, solver):
        self.params = with_grade(rc.ENV01_PARAMS, solver)

    def _pitch(self, qpos, u):
        return pitch_of(qpos) + (u - 0.5) * 0.05

    def physics(self, qpos, qvel, ws, ctrl, frame_skip=250):
        if qpos.dtype == torch.bfloat16:
            return bfloat16_state(self.physics, qpos, qvel, ws, ctrl)
        s = ps.control_step(ps.PhysState(qpos, qvel, ws), ctrl, self.params,
                            frame_skip=frame_skip)
        return s.qpos, s.qvel, s.warmstart

    def ctrl(self, state, action):
        return state["qvel"][:, 6:8] + action * WHEEL_SPEED_DELTA_MAX

    def step(self, state, action, u, phys=None):
        """One control step from `state` under `action` and uniforms `u`.
        `phys` = (qpos', qvel', ws') stands in for the physics when given.
        Returns (state', obs, reward, terminated, truncated, margin): margin
        is how far each env's termination decision lies from its threshold
        (radians)."""
        reward = base_reward(state["qvel"],
                             self._pitch(state["qpos"], u[:, 0]))
        if phys is None:
            phys = self.physics(state["qpos"], state["qvel"], state["ws"],
                                self.ctrl(state, action))
        post = dict(state, qpos=phys[0], qvel=phys[1], ws=phys[2],
                    t=state["t"] + 1)
        pitch_term = self._pitch(post["qpos"], u[:, 1]).abs()
        terminated = pitch_term > TERMINATE_PITCH
        obs, slots = observe(post, self._pitch(post["qpos"], u[:, 2]),
                             self._pitch(post["qpos"], u[:, 3]))
        post.update(slots)
        truncated = post["t"] >= self.max_episode_steps
        margin = (pitch_term - TERMINATE_PITCH).abs()
        return post, obs, reward, terminated, truncated, margin


    def fresh(self, s, obs):
        """(B,) bool: whether each env of state dict `s` with obs `obs` is
        a fresh episode as the reset makes it."""
        q, j = s["qpos"], self.reset_jitter + 1e-6
        pitch = pitch_of(q)
        noise = 0.025 + 1e-5
        return ((s["t"] == 0) & (s["qvel"] == 0).all(-1)
                & (s["ws"] == 0).all(-1)
                & (q[:, 0:2].abs() <= j).all(-1) & (q[:, 2] == 0)
                & (q[:, 7:9].abs() <= j).all(-1)
                & ((q[:, 3:7].square().sum(-1) - 1).abs() <= 1e-5)
                & (s["last_t"] == 0) & s["has_last"]
                & ((s["last_pitch"] - pitch).abs() <= noise)
                & ((obs[:, 0] * PITCH_MAX - pitch).abs() <= noise)
                & (obs[:, 1:] == 0).all(-1)
                & (s["target_wheel_speed"] == 0) & (s["target_yaw"] == 0))


ENV = Env01V2
