"""Paired deterministic evaluation: the selection eval of the burst ratchet,
the checkpoint sweep and the large policy eval.

Counterpart of what `tools/burst_refine.py`, `tools/sweep_checkpoints.py`
and `tools/eval_policy.py` share in the JAX package: a fixed key set per
seed (`burst_refine.py:250-260`) makes every snapshot of a selection meet
the same episodes, so the noise of the eval is mostly common-mode between
them. Here a seed forks the env (`ppo.fork_env`): every `paired_eval` with
the same seed and the same n resets the same episodes and makes the same
launch and noise draws, whatever the policy is, as long as the policy
leaves the generator alone (every act_fn here does).

  * `paired_eval`: n deterministic episodes from a seed through the
    `ChunkedEvaluator` (and its finiteness guard);
  * `auto_min_win`: the ratchet's default accept margin, 2 standard errors
    of a binomial proportion (`burst_refine.py:270-277`);
  * `act_fn_for`: the deterministic act fn of a checkpoint by its format
    (`eval_policy.py:50-92`).
"""

import math

import numpy as np
import torch

from ..envs.privileged import PrivilegedObsEnv
from ..export.onnx_writer import actor_head
from ..models import mlp
from ..ops import quant
from . import offpolicy
from .evaluation import ChunkedEvaluator
from .ppo import deterministic_action, fork_env


def paired_eval(env, act_fn, params, seed, n, max_steps=None, chunk=None,
                on_start=None):
    """(full_rate, mean_return, mean_len, rets, lens) of n deterministic
    episodes of a copy of `env` seeded with `seed`, acted by
    `act_fn(params, obs)`; the full-horizon rate counts episodes that
    reached `max_steps` (default: the env's horizon). `on_start(states,
    obs)` sees the episodes' reset before they run."""
    max_steps = max_steps or env.max_episode_steps
    twin = fork_env(env, seed)
    start = twin.reset(n)
    if on_start is not None:
        on_start(*start)
    rets, lens = ChunkedEvaluator(twin, act_fn, chunk).evaluate_detail(
        params, n, max_steps, start=start)
    return (float((lens >= max_steps).mean()), float(rets.mean()),
            float(lens.mean()), rets, lens)


def auto_min_win(p, n):
    """2 standard errors of a binomial proportion p over n episodes, with
    p clamped to [0.05, 0.95]: the smallest margin the ratchet tells apart
    from paired-selection noise."""
    p = min(max(p, 0.05), 0.95)
    return 2.0 * math.sqrt(p * (1.0 - p) / n)


def _actor_act(sac):
    def act(actor, obs):
        out = actor(obs.to(actor[0].w.dtype))
        if sac:                                         # tanh(mean)
            return torch.tanh(out.chunk(2, -1)[0])
        return torch.tanh(out).clamp(-1.0, 1.0)         # TD3 / DDPG
    return act


def _int8_act(fn, obs):
    return fn(obs)


def act_fn_for(params, env, int8=False):
    """(env, act_fn, policy) for a checkpoint's params dict (numpy, as
    `checkpoint.load` returns it): evaluate with `act_fn(policy, obs)` on
    the returned env.

    PPO / A2C params (`pi_w1`) act by the clipped policy mean; a teacher,
    whose `pi_w1` is wider than the env's obs, through `PrivilegedObsEnv`;
    an off-policy checkpoint (`actor/<i>/{w,b}`) by its actor, whose head
    is read against the env's act_dim (`onnx_writer.actor_head`): SAC's
    2 x act_dim-wide [mean, log_std] by tanh(mean), TD3 / DDPG's by
    tanh(out). `int8` runs the pi network through the int8 deployment path
    (`quant.int8_policy_fn` of `quant.quantize_policy(params)`)."""
    if "pi_w1" in params and np.shape(params["pi_w1"])[0] > env.obs_dim:
        env = PrivilegedObsEnv(env)
        width = np.shape(params["pi_w1"])[0]
        if width != env.obs_dim:
            raise ValueError(f"teacher obs width {width} != {env.obs_dim}")
    if int8:
        return env, _int8_act, quant.int8_policy_fn(
            quant.quantize_policy(params), env.device)
    if any(k.startswith("actor/") for k in params):
        layers = offpolicy.nest(params)["actor"]
        actor = offpolicy.MLP(offpolicy.Dense(
            torch.tensor(np.asarray(layer["w"]), device=env.device,
                         dtype=env.dtype),
            torch.tensor(np.asarray(layer["b"]), device=env.device,
                         dtype=env.dtype)) for layer in layers)
        head = actor_head(np.shape(layers[-1]["b"])[-1], env.act_dim)
        return env, _actor_act(head == "sac"), actor
    return env, deterministic_action, mlp.from_numpy_params(
        params, device=env.device, dtype=env.dtype)
