"""Deterministic-policy evaluation in chunks of control steps.

Counterpart of `balance_robot_tpu/train/evaluation.py::ChunkedEvaluator`
(`evaluate_detail` / `evaluate` / `record`), the evaluator behind `cli
test`, `PPO.evaluate`, the runner's eval gate and its recordings. A batch
of fresh episodes runs in lockstep; an env that is done is frozen (state,
obs, return and length stop changing), and reaching `max_steps` counts as
a truncation, so returns and lengths are exact at any step budget. The
host checks whether every episode is done once per chunk, not once per
step. `evaluate_detail` counts the live episodes' env-steps and all it
stepped (`utils/profiling.count`: `eval.live_env_steps`,
`eval.stepped_env_steps`).

Unlike the reference, a non-finite return raises instead of averaging to
NaN: the runner's eval gate would otherwise never save a best model again
and say nothing.

Reference semantics: SB3 EvalCallback's deterministic episode returns and
the RecordVideo trajectory capture.
"""

import numpy as np
import torch

from ..envs.base import tree_map
from ..utils import profiling


def _frozen(done, old, new):
    """`new` where the episode runs on, `old` (tensors or state trees)
    where it is done."""
    return tree_map(lambda a, b: torch.where(
        done.view((-1,) + (1,) * (a.dim() - 1)), a, b), old, new)


class ChunkedEvaluator:
    CHUNK = 250

    def __init__(self, env, act_fn, chunk=None):
        """act_fn(params, obs) -> actions must be the deterministic policy,
        already clipped to the action space."""
        self.env = env
        self.act_fn = act_fn
        self.chunk = int(chunk or self.CHUNK)

    @torch.no_grad()
    def evaluate_detail(self, params, n_episodes, max_steps=None,
                        start=None):
        """Per-episode (returns, lengths) numpy arrays of n fresh episodes,
        reset from the env's generator, or from `start` = (states, obs) of
        n episodes. Raises FloatingPointError when a return is not finite
        (checked once, after the rollout)."""
        max_steps = max_steps or self.env.max_episode_steps
        states, obs = self.env.reset(n_episodes) if start is None else start
        dev = obs.device
        ret = torch.zeros(n_episodes, dtype=self.env.dtype, device=dev)
        done = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
        t = torch.zeros(n_episodes, dtype=torch.int32, device=dev)
        steps = 0
        while steps < max_steps:
            k = min(self.chunk, max_steps - steps)
            for _ in range(k):
                states2, obs2, r, term, trunc = self.env.step(
                    states, self.act_fn(params, obs))
                states = _frozen(done, states, states2)
                obs = _frozen(done, obs, obs2)
                ret = ret + torch.where(done, torch.zeros_like(r), r)
                t = t + (~done).to(torch.int32)
                done = done | term | trunc | (t >= max_steps)
            steps += k
            if bool(done.all()):
                break
        rets = ret.cpu().numpy()
        n_bad = int((~np.isfinite(rets)).sum())
        if n_bad:
            raise FloatingPointError(
                f"{n_bad} of {n_episodes} evaluation episodes had a "
                "non-finite return")
        lens = t.cpu().numpy()
        # the env-steps of live episodes against all that were stepped: a
        # done episode is stepped on, frozen, until every episode is done
        # at a chunk's end or the horizon is reached
        profiling.count("eval.live_env_steps", int(lens.sum()))
        profiling.count("eval.stepped_env_steps", n_episodes * steps)
        return rets, lens

    def evaluate(self, params, n_episodes, max_steps=None):
        """Mean (return, episode length) over n deterministic episodes."""
        rets, lens = self.evaluate_detail(params, n_episodes, max_steps)
        return rets.mean(), lens.astype(np.float32).mean()

    @torch.no_grad()
    def record(self, params, max_steps=None):
        """One deterministic episode from the env's generator as a (T, nq)
        numpy qpos trajectory (T = max_steps) and its length; the state is
        frozen once the episode is done."""
        max_steps = max_steps or self.env.max_episode_steps
        state, obs = self.env.reset(1)
        done = torch.zeros(1, dtype=torch.bool, device=obs.device)
        qpos, alive = [], []
        steps = 0
        while steps < max_steps:
            chunk_qpos, chunk_alive = [], []
            for _ in range(self.chunk):
                state2, obs2, _, term, trunc = self.env.step(
                    state, self.act_fn(params, obs))
                chunk_alive.append(~done)
                state = _frozen(done, state, state2)
                obs = _frozen(done, obs, obs2)
                done = done | term | trunc
                chunk_qpos.append(state.phys.qpos[0])
            qpos.append(torch.stack(chunk_qpos).cpu().numpy())
            alive.append(torch.cat(chunk_alive).cpu().numpy())
            steps += self.chunk
            if bool(done.all()):
                break
        length = int(np.concatenate(alive)[:max_steps].sum())
        return np.concatenate(qpos)[:max_steps], length
