"""Fatal-state harvesting for the Env03 block envs.

Counterpart of `balance_robot_tpu/train/harvest.py`. A deterministic
policy runs N fresh episodes in lockstep; each episode's full state is
snapshotted at its most recent block launch, and an episode that then dies
yields its snapshot as a "fatal pre-impact state" (the block on its spawn
circle, the impact a few control steps out: the situation the policy
loses). Its consumers in the JAX package are `tools/oracle_probe.py` and
`tools/burst_refine.py`.

The rollout runs in chunks of control steps, with one host sync per chunk
(whether every episode is done), and stops at the horizon; an episode that
is done is frozen, as in `train/evaluation.py`. (The JAX harvest runs whole
chunks past the horizon, where every episode is done and nothing changes.)
"""

import numpy as np
import torch

from ..envs.base import tree_map
from ..models import mlp
from .ppo import fork_env


def _block_dist(state):
    """(B,) horizontal distance of the block from the robot."""
    q = state.phys.qpos
    return (q[:, 9:11] - q[:, 0:2]).square().sum(-1).sqrt()


def _where(mask, a, b):
    """`a` where `mask`, else `b`, leaf by leaf of two states or tensors."""
    return tree_map(lambda x, y: torch.where(
        mask.view((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


@torch.no_grad()
def harvest_fatal_states(env, params, episodes=512, seed=0, chunk=250,
                         max_states=512, start=None, uniforms=None):
    """Returns (bank, info): `bank` is a batched EnvState of fatal
    pre-impact snapshots (leading axis = state index), `info` a dict with
    the harvest's full-horizon rate and counts, each banked episode's
    `death_dt` (control steps from the snapshot to its end) and
    `info["obs"]`, the (N, 6) observation emitted by each snapshot's own
    step (the fd pitch_dot cannot be recomputed from the bare state).

    `env` is an Env03-family env (the block at qpos[9:16]), `params` the
    PPO params dict (numpy) whose clipped `policy_mean` acts. The episodes
    reset from a copy of `env` with a generator seeded with `seed`.
    `start` = (states, obs) replaces those resets and `uniforms` (T, B, 6)
    the launch draws of the first T steps (test hooks)."""
    max_steps = env.max_episode_steps
    env = fork_env(env, seed)
    net = mlp.from_numpy_params(params, device=env.device, dtype=env.dtype)
    states, obs = env.reset(episodes) if start is None else start
    dev = obs.device
    done = torch.zeros(episodes, dtype=torch.bool, device=dev)
    t = torch.zeros(episodes, dtype=torch.int32, device=dev)
    snap, snap_obs = states, obs
    snap_t = torch.zeros_like(t)
    prev_parked = torch.zeros_like(done)
    steps = 0
    while steps < max_steps:
        for i in range(steps, min(steps + chunk, max_steps)):
            a = net.policy_mean(obs.to(env.dtype)).clamp(-1.0, 1.0)
            u = uniforms[i] if uniforms is not None and i < len(
                uniforms) else None
            states2, obs2, _, term, trunc = env.step(states, a, u)
            alive = ~done
            d2 = _block_dist(states2)
            # a launch: the block was parked far away and is now on its
            # spawn circle
            fired = prev_parked & (d2 < 0.5) & alive
            snap = _where(fired, states2, snap)
            # bank the obs EMITTED by the snapshot's step: recomputed from
            # the snapshot, the fd pitch_dot would see dt = 0 and read 0
            # while the robot is pitching
            snap_obs = _where(fired, obs2, snap_obs)
            snap_t = torch.where(fired, t + 1, snap_t)
            states = _where(alive, states2, states)
            obs = _where(alive, obs2, obs)
            t = t + alive.to(torch.int32)
            done = done | term | trunc
            prev_parked = torch.where(alive, d2 > 2.0, prev_parked)
        steps += chunk
        if bool(done.all()):
            break
    lens, snap_t = t.cpu().numpy(), snap_t.cpu().numpy()
    # snap_t > 0 keeps only episodes that died after a RESPAWN launch:
    # reset fires the first block itself, and a death to it cannot be told
    # from a reset draw no policy could survive (about 13% of the scrambled
    # starts lie beyond the 50 degree bound)
    fatal = (lens < max_steps) & (snap_t > 0)
    idx = np.nonzero(fatal)[0][:max_states]
    sel = torch.as_tensor(idx, dtype=torch.long, device=dev)
    bank = tree_map(lambda x: x[sel], snap)
    info = dict(episodes=episodes, n_fatal=int(fatal.sum()),
                n_bank=len(idx), full_rate=float((lens >= max_steps).mean()),
                death_dt=lens[idx] - snap_t[idx], obs=snap_obs[sel])
    return bank, info
