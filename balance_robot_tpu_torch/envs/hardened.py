"""Training-only variants of an env: the burst ratchet's hardening and its
failure-replay resets.

Counterpart of the training-env patches of `tools/burst_refine.py`
(:129-240), which the JAX package applies by monkeypatching its training
env; here each is an explicit object, and selection and evaluation keep the
standard env:

  * `harden(env, ...)`: a copy of `env` with faster blocks (`block_speed`),
    a shorter respawn delay (`block_delay`), an attack side biased toward
    the back (`back_frac`: P(a slot is attacked from the back), decided by
    the same single uniform per slot as Env03-v2's 50/50 draw) and the
    survival reward (exactly 1.0 per step). The survival-reward step still
    makes its noise draws, so the generator's stream does not shift.
    `VecEnv` carries a slot's side across its resets (`carry_across_reset`),
    so `back_frac` acts when a slot is first reset, as in the JAX tool.
  * `ReplayResetEnv(env, bank, bank_obs, frac)`: resets that start a row
    from a banked fatal pre-impact state (`train/harvest.py`) with
    probability `frac`, at t = 0 and with the banked observation.
"""

import functools

import torch

from .base import tree_map


class _SurvivalReward:
    """Reward 1.0 for every step (the env's own step draws its noise before
    it asks for the reward)."""

    def _reward(self, state, u):
        return torch.ones(state.t.shape[0], dtype=self.dtype,
                          device=self.device)


@functools.lru_cache(maxsize=None)
def _with_survival_reward(cls):
    return type(cls.__name__, (_SurvivalReward, cls), {})


def harden(env, block_speed=None, block_delay=None, back_frac=None,
           survival_reward=False):
    """A copy of `env` (sharing its generator) with the hardening asked
    for; options left at None / False keep the env's own."""
    if back_frac is not None and not hasattr(env, "back_frac"):
        raise ValueError(f"{env.id} has no attack side to bias")
    cls = _with_survival_reward(type(env)) if survival_reward else type(env)
    twin = cls.__new__(cls)
    twin.__dict__.update(env.__dict__)
    for name, value in (("block_speed", block_speed),
                        ("block_delay", block_delay),
                        ("back_frac", back_frac)):
        if value is not None:
            setattr(twin, name, value)
    return twin


def _where(mask, a, b):
    return tree_map(lambda x, y: torch.where(
        mask.view((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


class ReplayResetEnv:
    """`env` whose resets start a row, with probability `frac`, from a state
    of `bank` (a batched EnvState of the env's scene, from
    `harvest_fatal_states`) at t = 0 (last_t = 0, so the next
    finite-difference pitch_dot sees the source episode's 5 ms), keeping its
    banked last_pitch, has_last and attack side, and emitting its banked
    obs `bank_obs` (N, obs_dim): the fd pitch_dot cannot be recomputed from
    the bare state. Every state it hands out marks such rows in
    `aux["replayed"]` (the initial reset's too, so VecEnv's picks between a
    step's state and its reset candidate match leaf for leaf).

    `resets` counts the rows its resets handed out (every reset candidate
    of a VecEnv step included) and `replayed` (a tensor on the env's device,
    read without a sync until asked) how many of them were replayed.
    Everything else is the wrapped env's."""

    def __init__(self, env, bank, bank_obs, frac):
        if bank.t.shape[0] == 0:
            raise ValueError("the bank is empty: train on the plain resets")
        self._env = env
        self.bank = bank
        self.bank_obs = bank_obs
        self.frac = frac
        self.resets = 0
        self.replayed = torch.zeros((), dtype=torch.int64, device=env.device)

    def __getattr__(self, name):
        # only reached for attributes not set on the wrapper itself
        env = self.__dict__.get("_env")
        if env is None:
            raise AttributeError(name)
        return getattr(env, name)

    def rewrap(self, env):
        """The same resets around another copy of the wrapped env
        (`train.ppo.fork_env` and `shard_env`), with counts of its own."""
        return ReplayResetEnv(env, self.bank, self.bank_obs, self.frac)

    def reset(self, n, draws=None):
        """n episodes: a plain reset of every row, then for every row a bank
        index and a uniform (from the env's generator, or `draws` = (index
        (n,) long, replay (n,) bool)); a row whose uniform is below `frac`
        takes its bank state."""
        state0, obs0 = self._env.reset(n)
        n_bank = self.bank.t.shape[0]
        if draws is None:
            u = self._env._uniform(n, 2)
            idx = (u[:, 0] * n_bank).long().clamp_max(n_bank - 1)
            use = u[:, 1] < self.frac
        else:
            idx, use = (d.to(self._env.device) for d in draws)
        picked = tree_map(lambda x: x[idx], self.bank)
        picked = picked._replace(t=torch.zeros_like(picked.t),
                                 last_t=torch.zeros_like(picked.last_t))
        state = _where(use, picked, state0)
        state = state._replace(aux={**state.aux, "replayed": use})
        obs = torch.where(use.unsqueeze(-1), self.bank_obs[idx], obs0)
        self.resets += n
        self.replayed = self.replayed + use.sum()
        return state, obs

    def carry_across_reset(self, old_state, new_state):
        """The wrapped env's carry (the slot's attack side), except that a
        replayed row keeps its own side: its block already flies that
        way."""
        carry = getattr(self._env, "carry_across_reset", None)
        if carry is None:
            return new_state
        carried = carry(old_state, new_state)
        side = torch.where(new_state.aux["replayed"],
                           new_state.aux["attack_front"],
                           carried.aux["attack_front"])
        return carried._replace(aux={**carried.aux, "attack_front": side})
