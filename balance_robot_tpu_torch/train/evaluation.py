"""Deterministic-policy evaluation in chunks of control steps.

Counterpart of `balance_robot_tpu/train/evaluation.py::ChunkedEvaluator`
(`evaluate_detail` / `evaluate`), the evaluator behind `cli test`,
`PPO.evaluate` and the runner's eval gate. A batch of fresh episodes runs
in lockstep; an env that is done is frozen (state, obs, return and length
stop changing), and reaching `max_steps` counts as a truncation, so returns
and lengths are exact at any step budget. The host checks whether every
episode is done once per chunk, not once per step.

Reference semantics: SB3 EvalCallback's deterministic episode returns.
"""

import numpy as np
import torch

from ..envs.base import tree_map


class ChunkedEvaluator:
    CHUNK = 250

    def __init__(self, env, act_fn, chunk=None):
        """act_fn(params, obs) -> actions must be the deterministic policy,
        already clipped to the action space."""
        self.env = env
        self.act_fn = act_fn
        self.chunk = int(chunk or self.CHUNK)

    @torch.no_grad()
    def evaluate_detail(self, params, n_episodes, max_steps=None):
        """Per-episode (returns, lengths) numpy arrays of n fresh episodes,
        reset from the env's generator."""
        max_steps = max_steps or self.env.max_episode_steps
        states, obs = self.env.reset(n_episodes)
        dev = obs.device
        ret = torch.zeros(n_episodes, dtype=self.env.dtype, device=dev)
        done = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
        t = torch.zeros(n_episodes, dtype=torch.int32, device=dev)
        steps = 0
        while steps < max_steps:
            for _ in range(min(self.chunk, max_steps - steps)):
                states2, obs2, r, term, trunc = self.env.step(
                    states, self.act_fn(params, obs))

                def keep(a, b):
                    return torch.where(
                        done.view((-1,) + (1,) * (a.dim() - 1)), a, b)

                states = tree_map(keep, states, states2)
                obs = keep(obs, obs2)
                ret = ret + torch.where(done, torch.zeros_like(r), r)
                t = t + (~done).to(torch.int32)
                done = done | term | trunc | (t >= max_steps)
            steps += self.chunk
            if bool(done.all()):
                break
        return ret.cpu().numpy(), t.cpu().numpy()

    def evaluate(self, params, n_episodes, max_steps=None):
        """Mean (return, episode length) over n deterministic episodes."""
        rets, lens = self.evaluate_detail(params, n_episodes, max_steps)
        return rets.mean(), lens.astype(np.float32).mean()
