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
    terminal_priv: torch.Tensor  # (B, priv_dim) pre-reset privileged critic
                                 # features ((B, 0) unless with_priv)


class VecEnv:
    def __init__(self, env, num_envs: int, with_priv: bool = False):
        self.env = env
        self.num_envs = num_envs
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        # privileged critic features (asymmetric actor-critic): surfaced
        # only when the trainer asks, so other users pay nothing
        self.priv_dim = env.priv_dim if (
            with_priv and getattr(env, "priv_dim", 0)) else 0

    def reset(self):
        return self.env.reset(self.num_envs)

    def step(self, states, actions, uniforms=None):
        """-> (states, StepOut). uniforms replaces the step's own draws (see
        the env's step); resets always draw from the env."""
        state2, obs, reward, terminated, truncated = self.env.step(
            states, actions, uniforms)
        done = terminated | truncated
        # every env gets a fresh reset candidate and the done ones take it:
        # no host sync on `done`. The reset's own obs re-anchors the fd
        # pitch_dot state at the new episode's pitch and t = 0, as the
        # reference's reset_model -> _get_obs does.
        rstate, robs = self.env.reset(self.num_envs)
        # env-instance properties that survive episode resets (Env03-v2's
        # attack side)
        if hasattr(self.env, "carry_across_reset"):
            rstate = self.env.carry_across_reset(state2, rstate)

        def pick(a, b):
            return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        new_state = tree_map(pick, rstate, state2)
        # pre-reset privileged features: the truncation value bootstrap
        # must see the same critic input as training
        priv = (self.env.privileged(state2) if self.priv_dim
                else obs.new_zeros((obs.shape[0], 0)))
        out = StepOut(obs=pick(robs, obs), reward=reward, done=done,
                      terminated=terminated, truncated=truncated,
                      terminal_obs=obs, terminal_priv=priv)
        return new_state, out
