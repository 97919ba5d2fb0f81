"""Does the critic anticipate block impacts? The privileged critic's
diagnostic.

Counterpart of `tools/value_probe.py`, with its options, defaults and
output lines. Deterministic episodes of an Env03 env record, per control
step, the critic's value V(s) on the input the checkpoint was trained on
([obs], or [obs, env.privileged(state)] where `vf_w1` has obs + priv rows),
the reward, block launches and the alive mask (`record`). `report` then
gives:

  * the explained variance of V against the empirical discounted
    return-to-go, the last 100 steps of each episode left out (there the
    return-to-go of a truncated episode is ill-defined);
  * the mean V trace aligned on launches, split by the episodes that
    survive the `--window` steps after the launch and those that die in
    them: an anticipating critic dips between launch and impact (~8
    steps), a blind one only after the hit.

The episodes reset from a copy of the env seeded with `--seed` and run in
chunks of `--chunk` steps (one host sync per chunk); an episode that is
done is frozen.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.value_probe \\
          models/Env03-v2_r3a/best_model.npz [--env Env03-v2] \\
          [--episodes 128] [--gamma 0.999]
"""

import argparse

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt
from .harvest import _block_dist, _where
from .ppo import deterministic_action, fork_env

TAIL = 100          # steps left out of the explained variance per episode
PRE = 5             # steps of a launch-aligned trace before the launch


def build_parser():
    """Every option and default of `tools/value_probe.py`, with `--device`
    in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.value_probe",
        description="Does the critic anticipate block impacts?")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--episodes", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--gamma", type=float, default=0.999)
    ap.add_argument("--window", type=int, default=40,
                    help="steps after a launch treated as the impact window")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the nets run (default: the "
                         "GPU; raises without one)")
    return ap


def critic_input(net, env):
    """Whether the critic reads [obs, privileged]: its input is wider than
    the actor's, by exactly the env's priv_dim."""
    obs_dim = net.pi_l1.in_features
    vf_in = net.vf_l1.in_features
    if vf_in > obs_dim and vf_in != obs_dim + env.priv_dim:
        raise ValueError(f"critic width {vf_in} != obs {obs_dim} + priv "
                         f"{env.priv_dim}")
    return vf_in > obs_dim


@torch.no_grad()
def record(env, net, episodes, seed=0, chunk=250, start=None,
           uniforms=None):
    """(V, R, F, A): (T, B) numpy arrays of the value, the reward of alive
    steps (0 after the end), launches seen while alive and the alive mask,
    T the steps run (whole chunks, at most the horizon).

    `start` = (states, obs) replaces the resets from a copy of `env`
    seeded with `seed`, and `uniforms` (T, B, 6) the launch draws of the
    first T steps (test hooks)."""
    max_steps = env.max_episode_steps
    use_priv = critic_input(net, env)
    env = fork_env(env, seed)
    states, obs = env.reset(episodes) if start is None else start
    dev = obs.device
    done = torch.zeros(episodes, dtype=torch.bool, device=dev)
    prev_parked = torch.zeros_like(done)
    rows = []
    steps = 0
    while steps < max_steps:
        for i in range(steps, min(steps + chunk, max_steps)):
            x = obs.to(env.dtype)
            if use_priv:
                x = torch.cat((x, env.privileged(states).to(env.dtype)), -1)
            v = net.value(x)
            u = uniforms[i] if uniforms is not None and i < len(
                uniforms) else None
            states2, obs2, r, term, trunc = env.step(
                states, deterministic_action(net, obs), u)
            alive = ~done
            d2 = _block_dist(states2)
            fired = prev_parked & (d2 < 0.5) & alive
            states = _where(done, states, states2)
            obs = _where(done, obs, obs2)
            rows.append((v, torch.where(alive, r, torch.zeros_like(r)),
                         fired, alive))
            done = done | term | trunc
            prev_parked = torch.where(alive, d2 > 2.0, prev_parked)
        steps += chunk
        if bool(done.all()):
            break
    return tuple(torch.stack(x).cpu().numpy() for x in zip(*rows))


def report(V, R, F, A, gamma, window):
    """The explained-variance line and the launch-aligned trace lines of
    (T, B) records."""
    T, B = V.shape
    lens = A.sum(0)
    # the discounted return-to-go of alive steps; an episode that died
    # ends with 0 beyond it
    G = np.zeros_like(R)
    acc = np.zeros(B)
    for t in range(T - 1, -1, -1):
        acc = R[t] + gamma * acc * A[t]
        G[t] = acc
    mask = A.copy()
    for b in range(B):
        mask[max(0, int(lens[b]) - TAIL):, b] = False
    m = mask.reshape(-1)
    g, v = G.reshape(-1)[m], V.reshape(-1)[m]
    ev = 1.0 - np.var(g - v) / (np.var(g) + 1e-8)
    lines = [f"explained variance of V vs discounted return-to-go "
             f"(gamma={gamma}, tails dropped): {ev:+.3f}"]
    trace_sur, trace_die = [], []
    for b in range(B):
        for t in np.nonzero(F[:, b])[0]:
            if t < PRE or t + window >= T:
                continue
            seg = V[t - PRE:t + window, b]
            (trace_sur if A[t:t + window, b].all() else trace_die).append(
                seg)
    for name, tr in (("survived window", trace_sur),
                     ("died in window", trace_die)):
        if not tr:
            lines.append(f"  launch-aligned V ({name}): none")
            continue
        tr = np.stack(tr)
        base = tr[:, :PRE].mean()
        lines.append(f"  launch-aligned V ({name}, n={len(tr)}): "
                     f"pre {base:7.1f}  launch+4 {tr[:, PRE + 4].mean():7.1f}"
                     f"  launch+8 {tr[:, PRE + 8].mean():7.1f}  "
                     f"launch+{window - 1} {tr[:, -1].mean():7.1f}")
        dip = base - tr[:, PRE + 8].mean()
        lines.append(f"    anticipation dip by impact (~launch+8): "
                     f"{dip:+.1f}")
    return lines


def run(args):
    """The probe for parsed `args`; returns (V, R, F, A)."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device)
    env.use_fast_solver()
    net = mlp.from_numpy_params(ckpt.load(args.model), device=env.device,
                                dtype=env.dtype)
    use_priv = critic_input(net, env)
    print(f"critic: {'privileged' if use_priv else 'symmetric'} "
          f"(vf input {net.vf_l1.in_features})")
    V, R, F, A = record(env, net, args.episodes, args.seed, args.chunk)
    lens = A.sum(0)
    print(f"{args.env} {args.model}: {args.episodes} episodes, "
          f"full-horizon {100 * (lens >= env.max_episode_steps).mean():.1f}%")
    for line in report(V, R, F, A, args.gamma, args.window):
        print(line)
    return V, R, F, A


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and probe."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
