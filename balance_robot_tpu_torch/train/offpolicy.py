"""Off-policy trainers on the batched env: SAC, TD3 and DDPG.

Counterpart of `balance_robot_tpu/train/offpolicy.py`, with its configs,
nets and update order (Stable Baselines3's defaults as the JAX package
reads them):

  * SAC: a squashed diagonal Gaussian actor (256-256 ReLU), twin Q nets,
    soft targets (tau 0.005), lr 3e-4, automatic entropy tuning toward
    -act_dim;
  * TD3: a deterministic tanh actor (400-300), twin Q nets, the actor
    stepped every `policy_delay` updates, target smoothing noise 0.2
    clipped at 0.5, exploration noise 0.1, lr 1e-3;
  * DDPG: TD3's machinery with policy_delay 1, no target smoothing and the
    reference factory's nets (pi 300-200, qf 200-150).

The nets keep the JAX tree's names and layout: each layer holds `w` of
shape (in, out) and `b` of shape (out,) and computes `x @ w + b`, so
`to_numpy_params` / `from_numpy_params` are renames and every
`models/*_SAC|_TD3|_DDPG/best_model.npz` loads as it is. Init is uniform
within +-1/sqrt(fan_in) with zero biases (the JAX package's `_init_mlp`,
not `nn.Linear`'s), drawn on the CPU so every device starts from the same
weights.

The replay buffer is preallocated on the env's device at `buffer_size`
rows and written in place, wrapping at its capacity; its write count
`ptr`, the env-step count and the update count stay Python ints on the
host, so the warm-up and `learning_starts` branches need no device sync.
Randomness: one `torch.Generator` on the env's device draws the actions,
the warm-up actions, the batch indices and the update's normals; the env
keeps its own for resets and noise; evaluation steps a copy of the env
with a generator of its own (`ppo.fork_env`).

Two details follow the JAX package where torch's habits would not:
optax's Adam steps on zero gradients, so the actor's steps that
`policy_delay` skips set zero gradients (never None) and step, which
decays the moments and moves the actor by momentum; and SAC's `actor_t`
is the initial (or warm-start) actor, never updated, kept so that the
checkpoints have the JAX package's keys.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..envs.vector import VecEnv
from .evaluation import ChunkedEvaluator
from .ppo import fork_env

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
NETS = ("actor", "q1", "q2", "q1_t", "q2_t", "actor_t")
TARGETS = (("q1_t", "q1"), ("q2_t", "q2"))


# ------------------------------------------------------------------ config

@dataclass(frozen=True)
class OffPolicyConfig:
    algo: str = "SAC"                 # SAC | TD3 | DDPG
    n_envs: int = 256
    buffer_size: int = 1_000_000
    batch_size: int = 256
    learning_starts: int = 100        # transitions (env steps summed over
                                      # all envs) before the first update
    train_freq: int = 1               # env steps per iteration
    gradient_steps: int = 1           # updates per env step
    lr: float = 3e-4                  # SAC; TD3/DDPG use 1e-3
    tau: float = 0.005
    gamma: float = 0.99
    # SAC entropy tuning
    ent_coef_auto: bool = True
    init_alpha: float = 1.0
    # TD3/DDPG
    action_noise: float = 0.1
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
    policy_delay: int = 2
    actor_hidden: tuple = (256, 256)
    critic_hidden: tuple = (256, 256)
    privileged_critic: bool = False   # Q reads [obs, act,
                                      # env.privileged(state)]


def default_config(algo, n_envs=256, **overrides):
    algo = algo.upper()
    if algo == "SAC":
        return OffPolicyConfig(algo="SAC", n_envs=n_envs, **overrides)
    if algo == "TD3":
        return OffPolicyConfig(algo="TD3", n_envs=n_envs,
                               lr=overrides.pop("lr", 1e-3),
                               actor_hidden=(400, 300),
                               critic_hidden=(400, 300), **overrides)
    if algo == "DDPG":
        # reference factory: pi [300, 200], qf [200, 150], noise sigma 0.1
        return OffPolicyConfig(algo="DDPG", n_envs=n_envs,
                               lr=overrides.pop("lr", 1e-3),
                               actor_hidden=(300, 200),
                               critic_hidden=(200, 150),
                               policy_delay=1, target_noise=0.0,
                               target_noise_clip=0.0, **overrides)
    raise ValueError(algo)


# -------------------------------------------------------------------- nets

class Dense(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class MLP(nn.ModuleList):
    """ReLU MLP over `Dense` layers: x @ w + b, with tanh on the output
    where asked (the JAX package's `_apply_mlp`)."""

    def forward(self, x, final_tanh=False):
        for i, layer in enumerate(self):
            x = x @ layer.w + layer.b
            if i < len(self) - 1:
                x = torch.relu(x)
            elif final_tanh:
                x = torch.tanh(x)
        return x


class OffPolicyNets(nn.Module):
    """actor, q1, q2, their targets q1_t, q2_t, actor_t and the scalar
    log_alpha; parameter names `actor.0.w` ... `log_alpha` (the
    checkpoint's `actor/0/w` ... with dots). The targets take no
    gradient."""

    def __init__(self, params, algo, device=None, dtype=torch.float32):
        super().__init__()
        self.algo = algo

        def tensor(x):      # a copy: the nets never share the arrays
            return torch.tensor(np.asarray(x), device=device, dtype=dtype)

        for name in NETS:
            setattr(self, name, MLP(Dense(tensor(layer["w"]),
                                          tensor(layer["b"]))
                                    for layer in params[name]))
            if name.endswith("_t"):
                getattr(self, name).requires_grad_(False)
        self.log_alpha = nn.Parameter(tensor(params["log_alpha"]))


def nest(params):
    """The nested tree of off-policy params given flat, path-joined keys
    (`actor/0/w`, as `checkpoint.load` returns them); a nested tree is
    returned as it is."""
    if not any("/" in k for k in params):
        return params
    tree = {}
    for key, value in params.items():
        name, *path = key.split("/")
        if not path:
            tree[name] = value
            continue
        layers = tree.setdefault(name, [])
        i, leaf = int(path[0]), path[1]
        while len(layers) <= i:
            layers.append({})
        layers[i][leaf] = value
    return tree


def from_numpy_params(params, algo, device=None, dtype=torch.float32):
    """OffPolicyNets from the JAX package's params tree (numpy; nested, or
    flat as a checkpoint loads)."""
    return OffPolicyNets(nest(params), algo, device=device, dtype=dtype)


def to_numpy_params(nets):
    """The JAX package's nested params tree (numpy, (in, out) weights) of
    `nets`: a copy, which later updates leave as it is."""
    def array(p):
        return p.detach().cpu().numpy().copy()

    out = {name: [{"w": array(layer.w), "b": array(layer.b)}
                  for layer in getattr(nets, name)] for name in NETS}
    out["log_alpha"] = array(nets.log_alpha)
    return out


def _init_mlp(gen, sizes, out_dim):
    """sizes = (input_dim, h1, h2, ...): weights uniform within
    +-1/sqrt(fan_in), zero biases; numpy float64."""
    dims = list(sizes) + [out_dim]
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float64)
        layers.append({"w": ((u * 2 - 1) / math.sqrt(fan_in)).numpy(),
                       "b": np.zeros(fan_out)})
    return layers


# ------------------------------------------------------------------ state

class Buffer(NamedTuple):
    obs: torch.Tensor        # (cap, obs_dim)
    act: torch.Tensor        # (cap, act_dim)
    rew: torch.Tensor        # (cap,)
    next_obs: torch.Tensor   # (cap, obs_dim): the terminal obs where done
    done: torch.Tensor       # (cap,) terminated only (a truncation
                             # bootstraps)
    priv: torch.Tensor       # (cap, priv_dim) critic-only features at obs
    next_priv: torch.Tensor  # ... and at next_obs ((cap, 0) when symmetric)


class OPTrainState(NamedTuple):
    net: OffPolicyNets       # the params; the optimizers update it in place
    opt_actor: torch.optim.Optimizer
    opt_critic: torch.optim.Optimizer   # q1 and q2 together
    opt_alpha: torch.optim.Optimizer
    buffer: Buffer           # written in place
    ptr: int                 # transitions written in all
    env_states: Any
    last_obs: torch.Tensor   # (n_envs, obs_dim) in the env's dtype
    gen: torch.Generator     # actions, batch indices, the update's normals
    env_gen: torch.Generator  # the training env's own generator
    steps: int               # vectorized env steps
    grad_steps: int          # updates applied


class OffPolicy:
    def __init__(self, env, config: OffPolicyConfig):
        self.env = env
        self.cfg = config
        # asymmetric critics only where the env exposes features
        self.priv_dim = (getattr(env, "priv_dim", 0)
                         if config.privileged_critic else 0)
        self.vec = VecEnv(env, config.n_envs, with_priv=self.priv_dim > 0)
        self.device = env.device
        self.dtype = env.dtype
        self.target_entropy = -float(env.act_dim)
        # evaluation steps its own copy of the env (reseeded by init)
        self.eval_env = fork_env(env, 1)
        self.evaluator = ChunkedEvaluator(
            self.eval_env,
            lambda net, obs: self._act(net, obs.to(self.dtype),
                                       deterministic=True))

    # ------------------------------------------------------------ params
    def _init_params(self, seed):
        """The JAX package's `_init_params` tree (actor, q1, q2, log_alpha)
        drawn from a CPU generator seeded with `seed`."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)
        od, ad = self.env.obs_dim, self.env.act_dim
        qin = od + ad + self.priv_dim   # priv last: a symmetric warm start
        # zero-pads the trailing rows
        actor_out = 2 * ad if cfg.algo == "SAC" else ad
        return {"actor": _init_mlp(gen, (od,) + cfg.actor_hidden, actor_out),
                "q1": _init_mlp(gen, (qin,) + cfg.critic_hidden, 1),
                "q2": _init_mlp(gen, (qin,) + cfg.critic_hidden, 1),
                "log_alpha": np.log(np.float64(cfg.init_alpha))}

    def _adapt_q_width(self, layers):
        """Resize a loaded Q net's first layer to this trainer's input
        width: zero rows for new trailing (privileged) inputs, so Q is
        unchanged where they are zero, or a wider checkpoint sliced back
        for a symmetric run."""
        qin = self.env.obs_dim + self.env.act_dim + self.priv_dim
        w = np.asarray(layers[0]["w"])
        if w.shape[0] < qin:
            w = np.concatenate([w, np.zeros((qin - w.shape[0], w.shape[1]),
                                            w.dtype)], 0)
        elif w.shape[0] > qin:
            w = w[:qin]
        return [{**layers[0], "w": w}, *layers[1:]]

    def init(self, seed, params=None):
        """A fresh OPTrainState: the nets from `seed` or warm-started from
        `params` (a prior run of the same algorithm: the JAX package's tree,
        nested or as a checkpoint loads it; the targets are re-seeded from
        the loaded online nets), an empty buffer, the trainer's generator
        seeded with `seed`, the evaluator's with seed + 1, and n_envs fresh
        episodes from the env's generator."""
        cfg = self.cfg
        tree = self._init_params(seed)
        if params is not None:
            loaded = dict(nest(params))
            missing = {"actor", "q1", "q2"} - set(loaded)
            if missing:
                raise ValueError(
                    f"warm-start params are missing networks {sorted(missing)}"
                    f" — not a {cfg.algo} checkpoint?")
            for qk in ("q1", "q2"):
                loaded[qk] = self._adapt_q_width(loaded[qk])
            tree = {**tree, **loaded}
        # SAC's actor_t is never updated: the initial actor, kept so that
        # the tree has the JAX package's keys
        tree = {**tree, "q1_t": tree["q1"], "q2_t": tree["q2"],
                "actor_t": tree["actor"]}
        net = OffPolicyNets(tree, cfg.algo, device=self.device,
                            dtype=self.dtype)

        def adam(params):
            return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.eval_env.generator.manual_seed(seed + 1)
        env_states, obs = self.vec.reset()
        cap, od, ad = cfg.buffer_size, self.env.obs_dim, self.env.act_dim

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        buf = Buffer(obs=zeros(cap, od), act=zeros(cap, ad), rew=zeros(cap),
                     next_obs=zeros(cap, od), done=zeros(cap),
                     priv=zeros(cap, self.priv_dim),
                     next_priv=zeros(cap, self.priv_dim))
        return OPTrainState(
            net=net, opt_actor=adam(net.actor.parameters()),
            opt_critic=adam([*net.q1.parameters(), *net.q2.parameters()]),
            opt_alpha=adam([net.log_alpha]), buffer=buf, ptr=0,
            env_states=env_states, last_obs=obs.to(self.dtype), gen=gen,
            env_gen=self.env.generator, steps=0, grad_steps=0)

    # ------------------------------------------------------------- actor
    def _normal(self, gen, n):
        return torch.randn((n, self.env.act_dim), generator=gen,
                           device=self.device, dtype=self.dtype)

    def _sac_dist(self, actor, obs):
        mean, log_std = actor(obs).chunk(2, -1)
        return mean, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    def _sac_sample(self, actor, obs, normal):
        """(tanh-squashed sample, its log-prob) for standard normal draws
        `normal`."""
        mean, log_std = self._sac_dist(actor, obs)
        std = torch.exp(log_std)
        z = mean + std * normal
        a = torch.tanh(z)
        # the tanh correction of SB3's SquashedDiagGaussian
        logp = (-0.5 * ((z - mean) / std) ** 2 - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        return a, logp - torch.log(1.0 - a * a + 1e-6).sum(-1)

    def _act(self, net, obs, normal=None, deterministic=False):
        """The behavior action (`normal`: standard normal draws) or, with
        `deterministic`, the serving action."""
        if self.cfg.algo == "SAC":
            if deterministic:
                return torch.tanh(self._sac_dist(net.actor, obs)[0])
            return self._sac_sample(net.actor, obs, normal)[0]
        a = net.actor(obs, final_tanh=True)
        if not deterministic:
            a = a + self.cfg.action_noise * normal
        return a.clamp(-1.0, 1.0)

    def _q(self, qnet, obs, act, priv):
        return qnet(torch.cat((obs, act, priv), -1))[..., 0]

    def _priv(self, env_states):
        """(n_envs, priv_dim) critic-only features of the states behind the
        current obs; (n_envs, 0) when symmetric."""
        if not self.priv_dim:
            return torch.zeros((self.cfg.n_envs, 0), dtype=self.dtype,
                               device=self.device)
        return self.env.privileged(env_states).to(self.dtype)

    # ----------------------------------------------------------- collect
    @torch.no_grad()
    def _collect(self, ts: OPTrainState, n_steps, draws=None):
        """n_steps steps of every env into the buffer -> (ts, mean step
        reward). `draws` (one dict per step, each key optional) replaces
        the trainer's own: "noise" (n_envs, act_dim) standard normals of
        the behavior action, "uniform" (n_envs, act_dim) warm-up actions in
        [-1, 1], "env" the env step's uniforms."""
        cfg, buf = self.cfg, ts.buffer
        B, cap = cfg.n_envs, cfg.buffer_size
        env_states, obs, ptr, steps = (ts.env_states, ts.last_obs, ts.ptr,
                                       ts.steps)
        rewards = []
        for i in range(n_steps):
            d = draws[i] if draws is not None else {}
            # uniform actions while fewer than learning_starts transitions
            # were collected before this step
            if steps * B < cfg.learning_starts:
                a = d.get("uniform")
                if a is None:
                    a = torch.rand((B, self.env.act_dim), generator=ts.gen,
                                   device=self.device, dtype=self.dtype
                                   ) * 2 - 1
            else:
                noise = d.get("noise")
                a = self._act(ts.net, obs, self._normal(ts.gen, B)
                              if noise is None else noise)
            a = a.to(self.device, self.dtype)
            priv = self._priv(env_states)
            env_states, out = self.vec.step(env_states, a, d.get("env"))
            done = out.done.unsqueeze(-1)
            idx = torch.arange(ptr, ptr + B, device=self.device) % cap
            buf.obs[idx] = obs
            buf.act[idx] = a
            buf.rew[idx] = out.reward.to(self.dtype)
            buf.next_obs[idx] = torch.where(done, out.terminal_obs,
                                            out.obs).to(self.dtype)
            buf.done[idx] = out.terminated.to(self.dtype)
            if self.priv_dim:
                buf.priv[idx] = priv
                buf.next_priv[idx] = torch.where(
                    done, out.terminal_priv.to(self.dtype),
                    self._priv(env_states))
            obs = out.obs.to(self.dtype)
            ptr += B
            steps += 1
            rewards.append(out.reward.mean())
        ts = ts._replace(env_states=env_states, last_obs=obs, ptr=ptr,
                         steps=steps)
        return ts, torch.stack(rewards).mean()

    # ------------------------------------------------------------ update
    def _update(self, ts: OPTrainState, idx=None, normals=None):
        """One gradient step of the critics, the actor (zero gradients on a
        step that `policy_delay` skips) and SAC's alpha, then the soft
        targets. `idx` (batch_size,) replaces the trainer's draw of buffer
        rows, `normals` = (target, actor) standard normals (batch_size,
        act_dim) its draws for SAC's two samples and TD3's target noise.
        Returns (ts, metrics of 0-dim tensors)."""
        cfg, net, buf = self.cfg, ts.net, ts.buffer
        n = cfg.batch_size
        if idx is None:
            high = max(min(ts.ptr, cfg.buffer_size), 1)
            idx = torch.randint(0, high, (n,), generator=ts.gen,
                                device=self.device)
        sac = cfg.algo == "SAC"
        if normals is None:
            n_t = (self._normal(ts.gen, n)
                   if sac or cfg.target_noise > 0 else None)
            n_a = self._normal(ts.gen, n) if sac else None
        else:
            n_t, n_a = (None if x is None else x.to(self.device, self.dtype)
                        for x in normals)
        idx = idx.to(self.device)
        obs, act, rew, nxt, done, priv, nxt_priv = (t[idx] for t in buf)
        alpha = net.log_alpha.detach().exp()

        # ---- the target, from the pre-update nets and alpha
        with torch.no_grad():
            if sac:
                na, nlogp = self._sac_sample(net.actor, nxt, n_t)
                qt = torch.minimum(self._q(net.q1_t, nxt, na, nxt_priv),
                                   self._q(net.q2_t, nxt, na, nxt_priv)
                                   ) - alpha * nlogp
            else:
                na = net.actor_t(nxt, final_tanh=True)
                if cfg.target_noise > 0:
                    eps = (cfg.target_noise * n_t).clamp(
                        -cfg.target_noise_clip, cfg.target_noise_clip)
                    na = (na + eps).clamp(-1.0, 1.0)
                qt = torch.minimum(self._q(net.q1_t, nxt, na, nxt_priv),
                                   self._q(net.q2_t, nxt, na, nxt_priv))
            y = rew + cfg.gamma * (1.0 - done) * qt

        # ---- the critics, one Adam over (q1, q2) and the loss l1 + l2
        critic = ts.opt_critic.param_groups[0]["params"]
        cl = (((self._q(net.q1, obs, act, priv) - y) ** 2).mean()
              + ((self._q(net.q2, obs, act, priv) - y) ** 2).mean())
        _step(ts.opt_critic, critic, torch.autograd.grad(cl, critic))

        # ---- the actor on the updated critics; every policy_delay-th step
        # takes its gradient, the others a zero gradient (optax steps on it)
        do_actor = ts.grad_steps % cfg.policy_delay == 0
        actor = ts.opt_actor.param_groups[0]["params"]
        with contextlib.nullcontext() if do_actor else torch.no_grad():
            if sac:
                a, logp = self._sac_sample(net.actor, obs, n_a)
                q = torch.minimum(self._q(net.q1, obs, a, priv),
                                  self._q(net.q2, obs, a, priv))
                al = (alpha * logp - q).mean()
            else:
                a = net.actor(obs, final_tanh=True)
                al = -self._q(net.q1, obs, a, priv).mean()
        _step(ts.opt_actor, actor, torch.autograd.grad(al, actor)
              if do_actor else [torch.zeros_like(p) for p in actor])

        # ---- SAC's entropy coefficient, on the actor loss's own log-prob
        if sac and cfg.ent_coef_auto:
            la = net.log_alpha
            loss = -(torch.exp(la) * (logp.detach()
                                      + self.target_entropy)).mean()
            _step(ts.opt_alpha, [la], torch.autograd.grad(loss, [la]))

        # ---- soft targets toward the updated nets (actor_t: TD3/DDPG, on
        # the steps that moved the actor)
        pairs = list(TARGETS) + ([("actor_t", "actor")]
                                 if not sac and do_actor else [])
        with torch.no_grad():
            for target, source in pairs:
                t = list(getattr(net, target).parameters())
                torch._foreach_mul_(t, 1.0 - cfg.tau)
                torch._foreach_add_(t, torch._foreach_mul(
                    list(getattr(net, source).parameters()), cfg.tau))
        ts = ts._replace(grad_steps=ts.grad_steps + 1)
        return ts, dict(critic_loss=cl.detach(), actor_loss=al.detach(),
                        alpha=net.log_alpha.detach().exp())

    # ----------------------------------------------------------- iterate
    def iteration(self, ts: OPTrainState, timer=None):
        """train_freq env steps of every env, then train_freq x
        gradient_steps updates once learning_starts transitions are in the
        buffer (none before: nothing changes, grad_steps included).
        `timer` (utils.profiling.Timer) times the "collect" and "update"
        phases. Returns (ts, metrics of 0-dim tensors; the losses are NaN
        where no update ran)."""
        cfg = self.cfg
        phase = timer or (lambda name: contextlib.nullcontext())
        with phase("collect"):
            ts, mean_rew = self._collect(ts, cfg.train_freq)
        with phase("update"):
            ms = []
            if ts.steps * cfg.n_envs >= cfg.learning_starts:
                for _ in range(cfg.train_freq * cfg.gradient_steps):
                    ts, m = self._update(ts)
                    ms.append(m)
        if ms:
            out = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            nan = torch.full((), float("nan"), dtype=self.dtype,
                             device=self.device)
            out = dict(critic_loss=nan, actor_loss=nan,
                       alpha=ts.net.log_alpha.detach().exp())
        out["mean_step_reward"] = mean_rew
        return ts, out

    # -------------------------------------------------------------- eval
    def evaluate(self, net, n_episodes, max_steps=None):
        """Mean (return, length) of n deterministic episodes of the
        evaluation env: tanh(mean) for SAC, the noiseless actor for
        TD3/DDPG."""
        return self.evaluator.evaluate(net, n_episodes, max_steps)


def _step(opt, params, grads):
    """Give `params` the gradients `grads` and step `opt`."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
