"""algorithm_factory: the reference's per-algorithm construction surface.

Counterpart of `balance_robot_tpu/train/factory.py`, with the same
defaults:

  * PPO: the SB3-default on-policy trainer (`train/ppo.py`);
  * A2C: the same trainer with SB3's A2C defaults: plain policy gradient
    (no ratio clip), n_steps 5, one epoch over the whole batch,
    gae_lambda 1.0, lr 7e-4 with RMSprop (decay 0.99, eps 1e-5), no
    advantage normalization;
  * SAC / TD3 / DDPG: the off-policy trainers (`train/offpolicy.py`) at
    SB3's defaults, at most 256 envs; DDPG gets the reference factory's
    nets (pi 300-200, qf 200-150) and its action noise 0.1.

Other names raise ValueError, as the reference's check of the name does.
"""

from .ppo import PPO, PPOConfig

KNOWN = ("PPO", "A2C", "SAC", "TD3", "DDPG")
IMPLEMENTED = KNOWN


def algorithm_factory(name, env, n_envs=1024, n_steps=None,
                      minibatch_size=None, **overrides):
    """Returns (trainer, config) for the given algorithm name."""
    if name not in KNOWN:
        raise ValueError(
            f"unknown algorithm {name!r} (reference accepts SB3 names; "
            f"known: {KNOWN})")
    if name == "PPO":
        cfg = PPOConfig(n_envs=n_envs, n_steps=n_steps or 64,
                        minibatch_size=minibatch_size or 4096, **overrides)
        return PPO(env, cfg), cfg
    if name == "A2C":
        ns = n_steps or 5                      # SB3 A2C default n_steps=5
        cfg = PPOConfig(n_envs=n_envs, n_steps=ns,
                        minibatch_size=minibatch_size or n_envs * ns,
                        n_epochs=1, clip_range=None, gae_lambda=1.0,
                        lr=overrides.pop("lr", 7e-4), optimizer="rmsprop",
                        normalize_advantage=False, **overrides)
        return PPO(env, cfg), cfg
    from .offpolicy import OffPolicy, default_config
    cfg = default_config(name, n_envs=min(n_envs, 256), **overrides)
    return OffPolicy(env, cfg), cfg
