"""Cal01: motor-calibration env (reference cal01.py), batch-first.

Counterpart of `balance_robot_tpu/envs/cal01.py`. Constant ctrl = [20, 20]
whatever the action; the episode terminates when the simulated time exceeds
1.0 s; reset places the robot at z = 0.15 with euler (0, 0, pi) written
through the reference's scrambled quaternion assignment (which lands on a
pi rotation about y, reproduced as built). `telemetry` returns the
`time, vel_l, vel_r` row the reference prints every step for fitting the
motor model against the real robot.
"""

import math

import torch

from ..physics.cuda_step import control_step
from ..physics.step import PhysState
from . import base
from .env01 import Env01V1


class Cal01(Env01V1):
    id = "Cal01"
    max_episode_steps = 6000

    def reset(self, n):
        """n episodes, all from the same pose: (EnvState, obs (n, 6))."""
        qpos = self._zeros((n, 9))
        qpos[:, 2] = 0.15
        zero = self._zeros(n)
        qpos[:, 3:7] = base.scipy_euler_to_mj_quat_scrambled(
            zero, zero, torch.full_like(zero, math.pi))
        zeros = self._zeros((n, 8))
        state = base.EnvState(
            phys=PhysState(qpos=qpos, qvel=zeros, warmstart=zeros.clone()),
            t=self._zeros(n, torch.int32),
            last_pitch=self._zeros(n), last_t=self._zeros(n, torch.float32),
            has_last=self._zeros(n, torch.bool),
            target_wheel_speed=self._zeros(n), target_yaw=self._zeros(n),
            aux={})
        return self._obs(state, self._zeros((n, 2)))

    def step(self, state, action, uniforms=None):
        """One control step at ctrl = [20, 20]; `action` only gives the
        batch size and `uniforms` is ignored (the env draws no noise)."""
        n = action.shape[0]
        u = self._zeros((n, 2))
        reward = self._reward(state, u[:, 0])
        ctrl = torch.full((n, 2), 20.0, dtype=self.dtype, device=self.device)
        phys = PhysState(*control_step(
            state.phys.qpos, state.phys.qvel, state.phys.warmstart, ctrl,
            None, self.params))
        state = state._replace(phys=phys, t=state.t + 1)
        terminated = base.time_of(state) > 1.0
        state, obs = self._obs(state, u)
        truncated = state.t >= self.max_episode_steps
        return state, obs, reward, terminated, truncated

    def telemetry(self, state):
        """(time, vel_l, vel_r), each (B,)."""
        return (base.time_of(state), state.phys.qvel[:, 6],
                state.phys.qvel[:, 7])
