"""Batched env stepping with SB3 VecEnv auto-reset.

Counterpart of `balance_robot_tpu/envs/vector.py`. B envs step in
lockstep; when an episode ends (terminated or truncated), the returned obs
is the reset obs of a fresh episode, and the pre-reset ("terminal") obs is
reported separately for bootstrapping, with the terminated/truncated split
that SB3's PPO uses for timeout value bootstrapping.
"""

from typing import NamedTuple

import torch

from .base import tree_map


class StepOut(NamedTuple):
    obs: torch.Tensor            # (B, obs_dim) post-auto-reset observation
    reward: torch.Tensor         # (B,)
    done: torch.Tensor           # (B,) terminated | truncated
    terminated: torch.Tensor     # (B,)
    truncated: torch.Tensor      # (B,)
    terminal_obs: torch.Tensor   # (B, obs_dim) pre-reset obs (valid when done)
    terminal_priv: torch.Tensor  # (B, 0): pre-reset privileged critic
                                 # features, which these envs do not have


class VecEnv:
    def __init__(self, env, num_envs: int):
        self.env = env
        self.num_envs = num_envs
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim

    def reset(self):
        return self.env.reset(self.num_envs)

    def step(self, states, actions, uniforms=None):
        """-> (states, StepOut). uniforms (B, 4) replaces the step's noise
        draws (see Env01V1.step); resets always draw from the env."""
        state2, obs, reward, terminated, truncated = self.env.step(
            states, actions, uniforms)
        done = terminated | truncated
        # every env gets a fresh reset candidate and the done ones take it:
        # no host sync on `done`. The reset's own obs re-anchors the fd
        # pitch_dot state at the new episode's pitch and t = 0, as the
        # reference's reset_model -> _get_obs does.
        rstate, robs = self.env.reset(self.num_envs)

        def pick(a, b):
            return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        new_state = tree_map(pick, rstate, state2)
        out = StepOut(obs=pick(robs, obs), reward=reward, done=done,
                      terminated=terminated, truncated=truncated,
                      terminal_obs=obs,
                      terminal_priv=obs.new_zeros((obs.shape[0], 0)))
        return new_state, out
