"""PPO and A2C on the batched env, matching Stable Baselines3's defaults.

Counterpart of `balance_robot_tpu/train/ppo.py`. One iteration collects
n_steps x n_envs transitions (the env steps through its kernel on the
card), computes GAE, and runs the update: n_epochs passes over the batch,
each in a fresh permutation cut into N // minibatch_size minibatches (the
remainder is dropped), with the clipped surrogate (PPO) or the plain
policy gradient (A2C, `clip_range=None`), per-minibatch advantage
normalization, the value loss and the entropy bonus. The optimizer chain
is `optim.py`'s: a global-norm clip, then Adam (or RMSprop for A2C).

SB3 semantics kept: the env action is the sample clipped to [-1, 1], while
the unclipped sample is stored and enters log_prob; where an episode is
truncated and not terminated, gamma * V(terminal obs) is added to the
stored reward (the timeout bootstrap); the episode statistics accumulate
over the whole run.

With `privileged_critic`, the value net reads [obs, env.privileged(state)]
(Env03's block features) while the actor keeps the 6-obs interface; a
symmetric checkpoint warm-starts it with zero rows on the new inputs
(`mlp.pad_privileged_critic`), so its value is unchanged at the start.

Randomness: an explicit `torch.Generator` on the env's device draws the
action noise and the permutations; the env keeps its own generator for
resets and noise; the evaluator steps a copy of the env with a generator of
its own (`fork_env`), so evaluating never moves the training streams.
Nothing in an iteration waits for the host: metrics stay 0-dim tensors on
the device until a caller reads them.

Data-parallel over ranks (`parallel/mesh.py`): a train state that
`mesh.shard_train_state` placed carries `ts.mesh`, and its env-batch
leaves hold this rank's n_envs / W envs. Each rank steps its envs through
the kernel (`shard_env`: the env's draws, and the action noise, are the
rank's rows of the global batch's, so the run equals the one-process run
of the same seed). Once per iteration the trajectory (obs, actions, logp,
value, reward, done, the critic's privileged inputs, the completed
episodes' returns) and the last value inputs are gathered, in one
collective. The update then runs replicated on the gathered (T, B_global)
batch: GAE, the explained variance and `_update` run unchanged on every
rank, so the params stay replicated with no gradient all-reduce and equal
the one-process update's. Why not all-reduce gradients, as the JAX
package's sharded jit does: each minibatch is cut from a permutation of
the global batch and normalizes its advantages over the whole minibatch,
so it needs samples from every rank anyway; an all-reduce per minibatch
step would be 320-640 collectives per iteration at the CLI's defaults (10
epochs x 32 minibatches) against this one; and the 64-64 MLP's update is
host-bound, so what the ranks must split is the rollout, where the
kernels spend the time.
"""

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from ..envs.privileged import PrivilegedObsEnv
from ..envs.vector import VecEnv
from ..models import mlp
from ..parallel import mesh as mesh_lib
from . import optim
from .evaluation import ChunkedEvaluator


@dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 16
    n_steps: int = 128          # per env and iteration
    n_epochs: int = 10
    minibatch_size: int = 64
    lr: float = 3e-4
    adam_eps: float = 1e-5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: Optional[float] = 0.2   # None -> plain policy gradient (A2C)
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    normalize_advantage: bool = True
    optimizer: str = "adam"             # "adam" | "rmsprop" (A2C)
    privileged_critic: bool = False     # the value net also reads
                                        # env.privileged(state)


class TrainState(NamedTuple):
    net: mlp.ActorCritic        # the params; the optimizer updates it in place
    opt: torch.optim.Optimizer  # the inner optimizer and its moments
    env_states: Any
    last_obs: torch.Tensor      # (B, obs_dim) in the net's dtype
    gen: torch.Generator        # action noise and minibatch permutations
    env_gen: torch.Generator    # the training env's own generator
    # streaming episode stats (SB3 Monitor-style)
    ep_ret: torch.Tensor        # (B,) running return of current episodes
    ep_len: torch.Tensor        # (B,) int32
    stat_sum_ret: torch.Tensor  # sum of completed-episode returns
    stat_n_eps: torch.Tensor
    mesh: Any = None            # parallel.mesh.Mesh of a sharded run: the
                                # env-batch leaves hold this rank's rows


def fork_env(env, seed):
    """A copy of `env` (the same scene, solver grade and device) that draws
    from a generator of its own, seeded with `seed`."""
    if isinstance(env, PrivilegedObsEnv):
        return PrivilegedObsEnv(fork_env(env._env, seed))
    twin = copy.copy(env)
    twin.generator = torch.Generator(device=env.device)
    twin.generator.manual_seed(seed)
    return twin


def shard_env(env, rank, size):
    """A copy of `env` for rank `rank` of `size` that shares its generator
    and draws every batch of uniforms at the global batch, keeping its own
    rows."""
    if isinstance(env, PrivilegedObsEnv):
        return PrivilegedObsEnv(shard_env(env._env, rank, size))
    twin = copy.copy(env)
    twin.shard = (rank, size)
    return twin


def explained_variance(returns, values):
    """SB3's explained variance, 1 - Var(ret - V) / Var(ret), population
    variances."""
    return 1.0 - torch.var(returns - values, correction=0) / (
        torch.var(returns, correction=0) + 1e-8)


def deterministic_action(net, obs):
    """The serving policy: clip(policy_mean(obs), -1, 1)."""
    return net.policy_mean(obs.to(net.log_std.dtype)).clamp(-1.0, 1.0)


class PPO:
    def __init__(self, env, config: PPOConfig = PPOConfig()):
        self.env = env
        self.cfg = config
        # privileged critic only where the env exposes features
        self.priv_dim = (getattr(env, "priv_dim", 0)
                         if config.privileged_critic else 0)
        self.vec = VecEnv(env, config.n_envs, with_priv=self.priv_dim > 0)
        self.device = env.device
        self.dtype = env.dtype
        # evaluation steps its own copy of the env (reseeded by init)
        self.eval_env = fork_env(env, 1)
        self.evaluator = ChunkedEvaluator(self.eval_env, deterministic_action)
        self._shard_vecs = {}

    # ------------------------------------------------------------ init
    def init(self, seed, params=None):
        """A fresh TrainState: the net from `seed` (orthogonal init drawn on
        the CPU, so every device starts from the same weights) or from the
        numpy params dict `params` (a warm start), the trainer's generator
        seeded with `seed`, the evaluator's with seed + 1, and n_envs fresh
        episodes from the env's generator."""
        vf_in = self.env.obs_dim + self.priv_dim
        if params is None:
            net = mlp.ActorCritic(
                self.env.obs_dim, self.env.act_dim, vf_obs_dim=vf_in,
                generator=torch.Generator().manual_seed(seed),
                dtype=self.dtype).to(self.device)
        else:
            # a symmetric checkpoint gets zero privileged rows; a privileged
            # one run symmetric keeps its proprioceptive projection
            params = mlp.deployable_params(
                mlp.pad_privileged_critic(params, vf_in), vf_in)
            net = mlp.from_numpy_params(params, device=self.device,
                                        dtype=self.dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.eval_env.generator.manual_seed(seed + 1)
        env_states, obs = self.vec.reset()
        B = self.cfg.n_envs
        zeros = torch.zeros((), dtype=self.dtype, device=self.device)
        return TrainState(
            net=net, opt=optim.make(self.cfg, net.parameters()),
            env_states=env_states, last_obs=obs.to(self.dtype), gen=gen,
            env_gen=self.env.generator, ep_ret=zeros.expand(B).clone(),
            ep_len=torch.zeros(B, dtype=torch.int32, device=self.device),
            stat_sum_ret=zeros.clone(), stat_n_eps=zeros.clone())

    # ------------------------------------------------------------ priv
    def _vobs(self, obs, env_states):
        """The critic's input: obs, or [obs, privileged features]."""
        if not self.priv_dim:
            return obs
        return torch.cat((obs, self.env.privileged(env_states).to(obs.dtype)),
                         -1)

    # --------------------------------------------------------- rollout
    def _vec_of(self, mesh):
        """The VecEnv of this rank's envs (all of them without a mesh)."""
        if mesh is None:
            return self.vec
        if mesh.shard not in self._shard_vecs:
            self._shard_vecs[mesh.shard] = VecEnv(
                shard_env(self.env, *mesh.shard),
                self.cfg.n_envs // mesh.size, with_priv=self.priv_dim > 0)
        return self._shard_vecs[mesh.shard]

    @torch.no_grad()
    def _rollout(self, ts: TrainState):
        """n_steps steps of every env (of this rank's, with a mesh) ->
        (ts, traj of (T, B, ...) tensors). Without a mesh the completed
        episodes go into the stats; with one, traj keeps their returns
        ("done_ret") for `iteration` to gather first."""
        cfg, net = self.cfg, ts.net
        T = cfg.n_steps
        vec = self._vec_of(ts.mesh)
        shard = None if ts.mesh is None else ts.mesh.shard
        env_states, obs = ts.env_states, ts.last_obs
        ep_ret, ep_len = ts.ep_ret, ts.ep_len
        steps = []
        for _ in range(T):
            vobs = self._vobs(obs, env_states)
            mean = net.policy_mean(obs)
            val = net.value(vobs)
            actions = net.sample(mean, ts.gen, shard)
            logp = net.log_prob(mean, actions)
            # SB3 clips the env's action to the Box; the unclipped sample is
            # what is stored and enters the gradient
            env_states, out = vec.step(env_states, actions.clamp(-1, 1))
            # timeout bootstrap where truncated and not terminated
            term_obs = out.terminal_obs.to(self.dtype)
            term_vobs = (torch.cat((term_obs, out.terminal_priv.to(
                self.dtype)), -1) if self.priv_dim else term_obs)
            boot = out.truncated & ~out.terminated
            reward = out.reward + torch.where(
                boot, cfg.gamma * net.value(term_vobs), 0.0)
            ep_ret = ep_ret + out.reward
            ep_len = ep_len + 1
            done_ret = torch.where(out.done, ep_ret, 0.0)
            ep_ret = torch.where(out.done, 0.0, ep_ret)
            ep_len = torch.where(out.done, 0, ep_len)
            step = dict(obs=obs, actions=actions, logp=logp, value=val,
                        reward=reward, done=out.done, done_ret=done_ret)
            if self.priv_dim:     # symmetric: vobs is obs, stored once
                step["vobs"] = vobs
            steps.append(step)
            obs = out.obs.to(self.dtype)
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        ts = ts._replace(env_states=env_states, last_obs=obs, ep_ret=ep_ret,
                         ep_len=ep_len)
        if ts.mesh is None:
            ts = self._add_episodes(ts, traj)
        return ts, traj

    @staticmethod
    def _add_episodes(ts, traj):
        """ts with the episodes that ended in `traj` (its "done_ret",
        popped, and "done") added to the stats, step by step."""
        stat_sum, stat_n = ts.stat_sum_ret, ts.stat_n_eps
        done_ret = traj.pop("done_ret")
        for t in range(done_ret.shape[0]):
            stat_sum = stat_sum + done_ret[t].sum()
            stat_n = stat_n + traj["done"][t].sum()
        return ts._replace(stat_sum_ret=stat_sum, stat_n_eps=stat_n)

    def _gather(self, ts, traj):
        """(traj, last value inputs) of every rank's envs, in one
        collective; the trajectory's flags ride as the working dtype."""
        last_vobs = self._vobs(ts.last_obs, ts.env_states)
        keys = list(traj)
        parts = [traj[k].to(self.dtype) if k == "done" else traj[k]
                 for k in keys] + [last_vobs.unsqueeze(0)]
        parts = mesh_lib.gather_rows(parts, ts.mesh, dim=1)
        traj = dict(zip(keys, parts))
        traj["done"] = traj["done"] != 0
        return traj, parts[-1][0]

    # ------------------------------------------------------------- GAE
    @torch.no_grad()
    def _gae(self, ts: TrainState, traj, last_vobs=None):
        """(advantages, returns); `last_vobs` (the critic's inputs after the
        last step) defaults to the train state's."""
        cfg = self.cfg
        if last_vobs is None:
            last_vobs = self._vobs(ts.last_obs, ts.env_states)
        next_val = ts.net.value(last_vobs)
        gae = torch.zeros_like(next_val)
        adv = torch.empty_like(traj["value"])
        for t in reversed(range(cfg.n_steps)):
            # float32 as in the JAX package, whose float64 runs therefore
            # round gamma * lambda * nonterm to float32 too
            nonterm = 1.0 - traj["done"][t].to(torch.float32)
            delta = (traj["reward"][t] + cfg.gamma * next_val * nonterm
                     - traj["value"][t])
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterm * gae
            adv[t] = gae
            next_val = traj["value"][t]
        return adv, adv + traj["value"]

    # ---------------------------------------------------------- update
    def _loss(self, net, mb):
        """(loss, policy loss, value loss, entropy) on one minibatch."""
        cfg = self.cfg
        mean = net.policy_mean(mb["obs"])
        val = net.value(mb["vobs" if self.priv_dim else "obs"])
        logp = net.log_prob(mean, mb["actions"])
        a = mb["adv"]
        if cfg.normalize_advantage:
            a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
        if cfg.clip_range is None:
            pg = -(a * logp).mean()     # A2C: plain policy gradient
        else:
            ratio = torch.exp(logp - mb["logp"])
            pg = -torch.minimum(
                a * ratio,
                a * ratio.clamp(1 - cfg.clip_range, 1 + cfg.clip_range),
            ).mean()
        v_loss = ((mb["ret"] - val) ** 2).mean()
        ent = mlp.entropy(net.log_std)
        loss = pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return loss, pg, v_loss, ent

    def _update(self, ts: TrainState, traj, adv, returns, perms=None):
        """n_epochs passes of minibatch steps. `perms` (one permutation of
        the N = n_steps x n_envs samples per epoch) replaces the trainer's
        own draws. Returns (ts, (n_epochs, 4) tensor of each epoch's mean
        loss, policy loss, value loss and entropy)."""
        cfg, net, opt = self.cfg, ts.net, ts.opt
        N = cfg.n_steps * cfg.n_envs
        flat = {"obs": traj["obs"].reshape(N, -1),
                "actions": traj["actions"].reshape(N, -1),
                "logp": traj["logp"].reshape(N),
                "adv": adv.reshape(N), "ret": returns.reshape(N)}
        if self.priv_dim:
            flat["vobs"] = traj["vobs"].reshape(N, -1)
        n_mb = N // cfg.minibatch_size
        params = list(net.parameters())
        epochs = []
        for e in range(cfg.n_epochs):
            perm = (perms[e].to(self.device) if perms is not None else
                    torch.randperm(N, generator=ts.gen, device=self.device))
            sums = torch.zeros(4, dtype=self.dtype, device=self.device)
            for i in range(n_mb):
                idx = perm[i * cfg.minibatch_size:(i + 1) * cfg.minibatch_size]
                losses = self._loss(net, {k: v[idx] for k, v in flat.items()})
                opt.zero_grad()
                losses[0].backward()
                optim.clip_grad_global_norm_(params, cfg.max_grad_norm)
                opt.step()
                sums += torch.stack(losses).detach()
            epochs.append(sums / n_mb)
        return ts, torch.stack(epochs)

    # --------------------------------------------------------- iterate
    def iteration(self, ts: TrainState, timer=None):
        """One iteration: collect n_steps x n_envs transitions, then update.
        `timer` (utils.profiling.Timer) times the "rollout" (with GAE and,
        with a mesh, the "gather" inside it) and the "update" phases.
        Returns (ts, metrics of 0-dim tensors), the same on every rank."""
        phase = timer or (lambda name: contextlib.nullcontext())
        with phase("rollout"):
            ts, traj = self._rollout(ts)
            last_vobs = None
            if ts.mesh is not None:
                with phase("gather"):
                    traj, last_vobs = self._gather(ts, traj)
                ts = self._add_episodes(ts, traj)
            adv, returns = self._gae(ts, traj, last_vobs)
            # SB3's explained variance over the rollout's value predictions
            ev = explained_variance(returns, traj["value"])
        with phase("update"):
            ts, epochs = self._update(ts, traj, adv, returns)
        loss, pg, vl, ent = epochs.mean(0)
        mean_ep_ret = ts.stat_sum_ret / ts.stat_n_eps.clamp_min(1.0)
        return ts, dict(loss=loss, pg_loss=pg, v_loss=vl, entropy=ent,
                        explained_variance=ev, mean_ep_return=mean_ep_ret,
                        n_episodes=ts.stat_n_eps)

    # ------------------------------------------------------------ eval
    def evaluate(self, net, n_episodes, max_steps=None):
        """Mean (return, length) of n deterministic episodes of the
        evaluation env (SB3 EvalCallback semantics)."""
        return self.evaluator.evaluate(net, n_episodes, max_steps)
