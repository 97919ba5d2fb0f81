"""Privileged-observation wrapper: the teacher's view of an env.

Counterpart of `balance_robot_tpu/envs/privileged.py`. `PrivilegedObsEnv`
widens an env's observation to `[obs, privileged(state)]`, so a standard
symmetric PPO run trains a privileged actor: a policy that also sees the
block's heading-frame kinematics (`envs/env03.py::privileged`). The teacher
is training infrastructure only (the real robot has no block sensor): it
measures how much of Env03-v2 cannot be solved through the 6-obs interface,
and it labels the 6-obs student's distillation data.

Everything except reset / step / obs_dim is the wrapped env's, so the
wrapper composes with VecEnv auto-reset (`carry_across_reset` included) and
with the ChunkedEvaluator.
"""

import torch


class PrivilegedObsEnv:
    def __init__(self, env):
        if not getattr(env, "priv_dim", 0):
            raise ValueError(
                f"{type(env).__name__} exposes no privileged features")
        self._env = env
        self.obs_dim = env.obs_dim + env.priv_dim

    def __getattr__(self, name):
        # only reached for attributes not set on the wrapper itself
        return getattr(self._env, name)

    def rewrap(self, env):
        """The same view of another copy of the wrapped env (`train.ppo.
        fork_env` and `shard_env`)."""
        return PrivilegedObsEnv(env)

    def _aug(self, state, obs):
        return torch.cat((obs, self._env.privileged(state)), -1)

    def reset(self, n):
        state, obs = self._env.reset(n)
        return state, self._aug(state, obs)

    def step(self, state, action, uniforms=None):
        state2, obs, reward, terminated, truncated = self._env.step(
            state, action, uniforms)
        return state2, self._aug(state2, obs), reward, terminated, truncated
