"""Behavior-clone a PD balance expert into the policy MLP (PPO warm start).

Counterpart of `balance_robot_tpu/train/bc.py`. Stage 0 of the curriculum:
a PD expert `u = -(k1 * pitch + k2 * pitch_dot)`, `a = (u, -u)`, rolled out
in `episodes` envs at once through `VecEnv` on the env's device (one
control step of the whole batch per kernel launch on the card), then
cloned into the actor-critic: the policy mean by MSE on the expert's
actions, the value head to the expert's discounted return-to-go, with
Adam (`torch.optim.Adam` at optax's defaults: eps 1e-8, eps_root 0).

Randomness comes from one `torch.Generator` on the env's device: the
expert's exploration noise and the minibatch indices. The net's
orthogonal init is drawn on the CPU from the generator's seed. The env
draws its resets and noise from its own generator.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..envs.vector import VecEnv
from ..models import mlp


@dataclass(frozen=True)
class BCConfig:
    episodes: int = 256        # parallel expert rollouts
    steps: int = 400           # control steps per rollout
    k1: float = 10.0           # pitch gain
    k2: float = 1.0            # pitch_dot gain
    noise: float = 0.05        # exploration noise during collection
    gamma: float = 0.999       # value-target discount (match the PPO run)
    log_std: float = -1.0      # cloned policy's initial log_std
    bc_steps: int = 2000
    batch: int = 4096
    lr: float = 1e-3


def pd_expert_actions(obs, cfg: BCConfig, generator):
    """The expert's actions (B, 2) in [-1, 1] on obs (B, 6), with
    cfg.noise x a standard normal draw from `generator`."""
    u = -(cfg.k1 * obs[:, 0] * 0.25 + cfg.k2 * obs[:, 1])
    a = torch.stack([u, -u], 1)
    a = a + cfg.noise * torch.randn(a.shape, generator=generator,
                                    device=a.device, dtype=a.dtype)
    return a.clamp(-1.0, 1.0)


def returns_to_go(rew, done, gamma):
    """Discounted return-to-go (T, B) of rewards (T, B), cut where an
    episode ended (done (T, B) bool); (1 - done) in float32 as the JAX
    package casts it."""
    g = torch.zeros_like(rew[0])
    out = torch.empty_like(rew)
    for t in reversed(range(rew.shape[0])):
        g = rew[t] + gamma * g * (1.0 - done[t].to(torch.float32))
        out[t] = g
    return out


@torch.no_grad()
def collect(env, cfg: BCConfig, generator):
    """Expert rollouts -> (obs (N, 6), actions (N, 2), return-to-go (N,)),
    N = steps x episodes, time-major, on the env's device."""
    vec = VecEnv(env, cfg.episodes)
    states, obs = vec.reset()
    traj = {"obs": [], "act": [], "rew": [], "done": []}
    for _ in range(cfg.steps):
        a = pd_expert_actions(obs, cfg, generator)
        states, out = vec.step(states, a)
        for k, v in (("obs", obs), ("act", a), ("rew", out.reward),
                     ("done", out.done)):
            traj[k].append(v)
        obs = out.obs
    traj = {k: torch.stack(v) for k, v in traj.items()}
    rtg = returns_to_go(traj["rew"], traj["done"], cfg.gamma)
    n = cfg.steps * cfg.episodes
    return (traj["obs"].reshape(n, -1), traj["act"].reshape(n, -1),
            rtg.reshape(n))


def loss(net, obs, act, rtg):
    """(total, action MSE, value MSE): MSE of the policy mean to the
    expert's actions plus 0.1 x MSE of the value to the return-to-go."""
    l_pi = ((net.policy_mean(obs) - act) ** 2).mean()
    l_v = ((net.value(obs) - rtg) ** 2).mean()
    return l_pi + 0.1 * l_v, l_pi, l_v


def fit_step(net, opt, obs, act, rtg):
    """One Adam step of `loss` on a minibatch; returns (action MSE, value
    MSE) before the step, as 0-dim tensors."""
    total, l_pi, l_v = loss(net, obs, act, rtg)
    opt.zero_grad()
    total.backward()
    opt.step()
    return l_pi.detach(), l_v.detach()


def fit(env, cfg: BCConfig, generator, data=None, verbose=False):
    """The cloned params dict (numpy, warm-startable by PPO), with
    log_std = cfg.log_std. `data` (obs, actions, return-to-go) replaces the
    expert rollouts."""
    if data is None:
        data = collect(env, cfg, generator)
    obs, act, rtg = (t.to(env.dtype) for t in data)
    net = mlp.ActorCritic(
        env.obs_dim, env.act_dim,
        generator=torch.Generator().manual_seed(generator.initial_seed()),
        dtype=env.dtype).to(obs.device)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)
    for i in range(cfg.bc_steps):
        idx = torch.randint(0, obs.shape[0], (cfg.batch,),
                            generator=generator, device=obs.device)
        l_pi, l_v = fit_step(net, opt, obs[idx], act[idx], rtg[idx])
        if verbose and (i % 500 == 0 or i == cfg.bc_steps - 1):
            print(f"bc step {i}: action MSE {float(l_pi):.5f} "
                  f"value MSE {float(l_v):.1f}", flush=True)
    params = mlp.to_numpy_params(net)
    params["log_std"] = np.full(env.act_dim, cfg.log_std,
                                params["log_std"].dtype)
    return params
