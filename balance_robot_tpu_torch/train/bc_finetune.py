"""DAgger fine-tune: clone recovery demonstrations into the flagship policy,
anchored on the policy's own behavior.

Counterpart of `tools/bc_finetune.py`, with its options, defaults and
output lines:

  * the dagger set: the (obs, act) pairs of each `--dagger` file (written
    by `train/mpc_dagger.py`), actions clipped to [-1, 1];
  * the anchor set: the obs of `--anchor-episodes` deterministic episodes
    of the policy (a copy of the env seeded with `--seed` + 7, chunks of
    250 steps, the obs before each alive step), labelled with the
    policy's own clipped mean;
  * `--steps` Adam steps (optax's defaults: b1 0.9, b2 0.999, eps 1e-8;
    lr `--lr`) on batches of n_d = max(1, int(batch x dagger_frac))
    dagger rows and batch - n_d anchor rows drawn uniformly: the loss is
    dagger_frac x the dagger MSE + (1 - dagger_frac) x `--anchor-weight`
    x the anchor term, the MSE of the mean, or under `--kl-anchor` the
    Gaussian KL(new || old) with the frozen log_std, sum_d (d mu_d)^2 /
    (2 sigma_d^2). Only the policy mean's layers step: the value net and
    log_std get zero gradients, which leave them exactly as they were in
    optax's Adam too;
  * with `--eval-every` N, a selection eval of `--select-episodes` every N
    steps and after the last keeps the best snapshot by (full-horizon
    share, mean return) compared as a tuple, from the initial policy on;
    the evals pair their episodes through `selection.paired_eval` at
    `--seed` + 1 (the port's form of the tool's fixed keys);
  * the final eval of `--eval-episodes` at `--seed`, then
    `checkpoint.save` into `--out`/best_model.npz.

`--out` defaults to models/Env03-v2_dagger, under the working directory.
`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.bc_finetune \\
          models/Env03-v2_r2f/best_model.npz --dagger runs/dagger_mpc.npz \\
          --out models/Env03-v2_dagger --steps 3000 --dagger-frac 0.3
"""

import argparse
import pathlib
import time

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt
from . import selection
from .harvest import _where
from .ppo import deterministic_action, fork_env

CHUNK = 250
ANCHOR_SEED = 7             # the anchor episodes' seed offset
SELECT_SEED = 1             # the selection evals' seed offset


def build_parser():
    """Every option and default of `tools/bc_finetune.py`, with `--device`
    in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.bc_finetune",
        description="DAgger fine-tune anchored on the policy's own "
                    "behavior.")
    ap.add_argument("model")
    ap.add_argument("--dagger", action="append", required=True,
                    help="npz from train/mpc_dagger.py (repeatable)")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--anchor-episodes", type=int, default=256,
                    help="on-policy episodes whose (obs, own-mean) pairs "
                         "anchor nominal behavior during the clone")
    ap.add_argument("--dagger-frac", type=float, default=0.3,
                    help="fraction of each batch drawn from the dagger set")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-episodes", type=int, default=512)
    ap.add_argument("--out", default="models/Env03-v2_dagger")
    ap.add_argument("--kl-anchor", action="store_true",
                    help="anchor in the policy's own action-distribution "
                         "geometry: Gaussian KL(new||old) on anchor obs "
                         "instead of raw mean-MSE (with sigma ~0.03 about "
                         "550x stronger per unit mean shift)")
    ap.add_argument("--anchor-weight", type=float, default=1.0,
                    help="multiplier on the anchor term; with --kl-anchor "
                         "weights in ~[0.02, 0.5] lie between a plain-MSE "
                         "anchor's collapse and a too-stiff clone")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run a selection eval every N clone steps and keep "
                         "the best snapshot (0 = off, report/save only the "
                         "final params)")
    ap.add_argument("--select-episodes", type=int, default=128,
                    help="episodes per mid-clone selection eval (paired "
                         "episodes; the winner is reported on a fresh seed)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs, the nets and the data live "
                         "(default: the GPU; raises without one)")
    return ap


def load_dagger(paths):
    """The dagger set of the npz files: (obs (N, 6), act (N, 2) clipped to
    [-1, 1]) numpy arrays."""
    obs, act = [], []
    for path in paths:
        with np.load(path) as z:
            obs.append(z["obs"])
            act.append(z["act"])
    return np.concatenate(obs), np.clip(np.concatenate(act), -1.0, 1.0)


@torch.no_grad()
def collect_anchor(env, net, episodes, seed=0, start=None, uniforms=None):
    """The obs (N, 6) before every alive step of `episodes` deterministic
    episodes of a copy of `env` seeded with `seed`, step by step in order,
    the episodes of a step in order. `start` = (states, obs) replaces the
    resets and `uniforms` (T, B, 6) the launch draws of the first T steps
    (test hooks)."""
    max_steps = env.max_episode_steps
    env = fork_env(env, seed)
    states, obs = env.reset(episodes) if start is None else start
    done = torch.zeros(episodes, dtype=torch.bool, device=obs.device)
    kept = []
    steps = 0
    while steps < max_steps:
        for i in range(steps, min(steps + CHUNK, max_steps)):
            u = uniforms[i] if uniforms is not None and i < len(
                uniforms) else None
            states2, obs2, _, term, trunc = env.step(
                states, deterministic_action(net, obs), u)
            kept.append(obs[~done])
            states = _where(done, states, states2)
            obs = _where(done, obs, obs2)
            done = done | term | trunc
        steps += CHUNK
        if bool(done.all()):
            break
    return torch.cat(kept)


class Clone:
    """The anchored clone of `net` (an ActorCritic, trained in place) on the
    dagger rows (obs_d, act_d) and the anchor rows (obs_a, act_a), tensors
    on the net's device."""

    def __init__(self, net, obs_d, act_d, obs_a, act_a, batch, dagger_frac,
                 lr, kl_anchor=False, anchor_weight=1.0):
        self.net = net
        self.obs_d, self.act_d, self.obs_a, self.act_a = (
            x.to(net.log_std.dtype) for x in (obs_d, act_d, obs_a, act_a))
        self.n_d = max(1, int(batch * dagger_frac))
        self.n_a = batch - self.n_d
        self.frac, self.weight = dagger_frac, anchor_weight
        self.kl = kl_anchor
        # log_std is frozen: KL(new||old) per anchor obs is
        # sum_d (d mu_d)^2 / (2 sigma_d^2)
        self.inv_2var = 0.5 * torch.exp(-2.0 * net.log_std.detach())
        # the loss reaches only the policy mean's layers
        self.params = [p for name, p in net.named_parameters()
                       if name.startswith("pi_")]
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def loss(self, o, a):
        """(loss, dagger MSE, anchor term) on a batch whose first n_d rows
        are dagger rows."""
        pred = self.net.policy_mean(o)
        n_d = self.n_d
        l_d = ((pred[:n_d] - a[:n_d]) ** 2).mean()
        sq = (pred[n_d:] - a[n_d:]) ** 2
        l_a = (sq * self.inv_2var).sum(-1).mean() if self.kl else sq.mean()
        return (self.frac * l_d + (1 - self.frac) * self.weight * l_a, l_d,
                l_a)

    def train_step(self, gen, idx=None):
        """One Adam step on a batch drawn from `gen`; `idx` = (dagger rows
        (n_d,), anchor rows (n_a,)) replaces the draws. Returns the dagger
        MSE and the anchor term (0-dim tensors)."""
        dev = self.obs_d.device
        if idx is None:
            idx = (torch.randint(0, len(self.obs_d), (self.n_d,),
                                 generator=gen, device=dev),
                   torch.randint(0, len(self.obs_a), (self.n_a,),
                                 generator=gen, device=dev))
        i_d, i_a = (i.to(dev) for i in idx)
        o = torch.cat((self.obs_d[i_d], self.obs_a[i_a]))
        a = torch.cat((self.act_d[i_d], self.act_a[i_a]))
        loss, l_d, l_a = self.loss(o, a)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return l_d.detach(), l_a.detach()


def better(score, best):
    """Whether `score` = (full, ret) beats `best` = (full, ret, ...),
    compared as the tuple (full, ret)."""
    return tuple(score[:2]) > tuple(best[:2])


def run(args):
    """The clone for parsed `args`. Returns {"params": the saved numpy
    params, "best": the selection's (full, ret, step) or None, "final":
    the final eval's (full, ret, len)}."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device)
    env.use_fast_solver()
    params = ckpt.load(args.model)
    max_steps = env.max_episode_steps
    net = mlp.from_numpy_params(params, device=env.device, dtype=env.dtype)

    obs_d, act_d = load_dagger(args.dagger)
    print(f"dagger set: {obs_d.shape[0]} pairs", flush=True)
    t0 = time.time()
    obs_a = collect_anchor(env, net, args.anchor_episodes,
                           args.seed + ANCHOR_SEED)
    with torch.no_grad():
        act_a = deterministic_action(net, obs_a)
    print(f"anchor set: {obs_a.shape[0]} on-policy pairs "
          f"({time.time() - t0:.0f}s)", flush=True)
    clone = Clone(net, torch.as_tensor(obs_d, device=env.device),
                  torch.as_tensor(act_d, device=env.device), obs_a, act_a,
                  args.batch, args.dagger_frac, args.lr, args.kl_anchor,
                  args.anchor_weight)

    def full_eval(seed, episodes):
        return selection.paired_eval(env, deterministic_action, net, seed,
                                     episodes, max_steps)[:3]

    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed)
    t0 = time.time()
    best = None               # (full, ret, step, params) on paired episodes
    if args.eval_every:
        f0, r0, _ = full_eval(args.seed + SELECT_SEED, args.select_episodes)
        best = (f0, r0, -1, mlp.to_numpy_params(net))
        print(f"[bc  init] selection full={100 * f0:.1f}% ret={r0:.0f} "
              f"({args.select_episodes} paired episodes)", flush=True)
    anchor = "kl" if args.kl_anchor else "mse"
    for i in range(args.steps):
        l_d, l_a = clone.train_step(gen)
        if i % 500 == 0 or i == args.steps - 1:
            print(f"[bc {i:5d}] dagger-mse {float(l_d):.5f} "
                  f"anchor-{anchor} {float(l_a):.5f}", flush=True)
        if args.eval_every and ((i + 1) % args.eval_every == 0
                                or i == args.steps - 1):
            f, r, _ = full_eval(args.seed + SELECT_SEED,
                                args.select_episodes)
            tag = ""
            if better((f, r), best):
                best = (f, r, i, mlp.to_numpy_params(net))
                tag = "  <-- new best"
            print(f"[bc {i:5d}] selection full={100 * f:.1f}% "
                  f"ret={r:.0f}{tag}", flush=True)
    if best is not None:
        print(f"selection winner: step {best[2]} full={100 * best[0]:.1f}% "
              f"ret={best[1]:.0f}", flush=True)
        net = mlp.from_numpy_params(best[3], device=env.device,
                                    dtype=env.dtype)
    print(f"clone done ({time.time() - t0:.0f}s)", flush=True)

    full, ret, length = full_eval(args.seed, args.eval_episodes)
    print(f"cloned policy: full={100 * full:.1f}% ret={ret:.0f} "
          f"len={length:.0f}  ({args.eval_episodes} episodes)")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    saved = mlp.to_numpy_params(net)
    ckpt.save(out / "best_model", saved)
    print(f"saved -> {out / 'best_model.npz'}")
    return dict(params=saved, best=None if best is None else best[:3],
                final=(full, ret, length))


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and clone."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
