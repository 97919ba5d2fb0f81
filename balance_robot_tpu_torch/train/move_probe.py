"""EnvMove05-v1 scripted-policy probe: is the registered 900 bar reachable?

Counterpart of `tools/move_probe.py`, with its options, defaults and
output lines. The reward's denominator is the policy's own previous
action (`tws = a0 * 20`), so an accelerate / harvest limit cycle can clear
900. Two scripted families run over their parameter grids:

  1. CYCLE (stateful, a square wave on the step counter): accelerate at
     `a_hi` for `n_hi` steps, harvest at `a_lo` for `n_lo` steps;
  2. THRESH (memoryless, a sigmoid of the observable wheel speed): what
     the deployment MLP (obs = [ws/170, yaw/45, 0 x 8]) can express.

Each family's grid of G members meets the same `--seeds` S starts: the S
episodes reset once (a copy of the env seeded with 7) and tiled, so the
flat batch of G x S envs holds member g's episode s at g S + s, as the
tool's repeated grid and tiled keys do. Each rollout runs the horizon
(or `--max-steps`) with the episodes that are done frozen; an episode's
length is its state's step count. The tool prints the top 5 members of
each family by mean return and its best.

The JAX tool's `--pallas` switch is gone, as `--physics` went from the
other ports: there is no switch; the device of the tensors picks the
physics (CUDA tensors launch the walled-corridor kernel, CPU tensors run
its plain version). `--device cuda|cpu` takes the place of `--platform`:
left at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.move_probe [--seeds 4]
"""

import argparse

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.base import tree_map
from .harvest import _where
from .ppo import fork_env

START_SEED = 7
REGISTERED = 900.0

# (n_hi, n_lo, a_hi, a_lo)
CYCLE_GRID = [(n_hi, n_lo, a_hi, a_lo)
              for n_hi in (10.0, 20.0, 40.0, 80.0)
              for n_lo in (40.0, 80.0, 160.0, 320.0)
              for a_hi in (1.0,)
              for a_lo in (0.001, 0.002, 0.005, 0.01)]
# (mid, width, a_hi, a_lo)
THRESH_GRID = [(mid, width, a_hi, a_lo)
               for mid in (1.0, 2.0, 4.0, 6.0)
               for width in (0.1, 0.25, 1.0)
               for a_hi in (1.0,)
               for a_lo in (0.001, 0.002, 0.005, 0.01)]


def build_parser():
    """The options and defaults of `tools/move_probe.py` less `--platform`
    and `--pallas`, plus `--device`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.move_probe",
        description="EnvMove05-v1 scripted-policy probe.")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="shorten the horizon (smoke only; returns then do "
                         "NOT measure the 900-over-700 bar)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs run (default: the GPU; raises "
                         "without one)")
    return ap


def _action(a0):
    return torch.stack((a0, torch.zeros_like(a0)), -1)


def cycle_policy(p, obs, t):
    """(B, 2) actions of CYCLE members p (B, 4) at scan step t."""
    n_hi, n_lo, a_hi, a_lo = p.unbind(-1)
    phase = torch.remainder(torch.full_like(n_hi, float(t)), n_hi + n_lo)
    return _action(torch.where(phase < n_hi, a_hi, a_lo))


def thresh_policy(p, obs, t):
    """(B, 2) actions of THRESH members p (B, 4): a0 falls from a_hi to
    a_lo as the wheel speed passes `mid`."""
    mid, width, a_hi, a_lo = p.unbind(-1)
    ws = obs[:, 0] * 170.0              # the de-normalized observable
    g = torch.sigmoid((mid - ws) / width)
    return _action(a_lo + (a_hi - a_lo) * g)


FAMILIES = (("CYCLE", cycle_policy, CYCLE_GRID),
            ("THRESH", thresh_policy, THRESH_GRID))


def flat_batch(states, obs, grid, seeds):
    """The flat batch of G x S envs: member g's episode s at g S + s.
    Returns (the states and obs of S starts tiled G times, the grid rows
    (G S, 4) repeated S times each)."""
    G = len(grid)
    tile = tree_map(lambda x: x.repeat((G,) + (1,) * (x.dim() - 1)),
                    (states, obs))
    rows = torch.tensor(grid, dtype=torch.float32,
                        device=obs.device).repeat_interleave(seeds, 0)
    return tile[0], tile[1], rows


@torch.no_grad()
def rollout(env, policy, grid, seeds, T, start=None):
    """(returns (G, S), lengths (G, S)) of every member of `grid` from the
    same `seeds` starts (default: a fresh reset of a copy of `env` seeded
    with 7, or `start` = (states, obs) of S envs), T steps at most."""
    G = len(grid)
    if start is None:
        start = fork_env(env, START_SEED).reset(seeds)
    states, obs, rows = flat_batch(*start, grid, seeds)
    ret = torch.zeros(G * seeds, dtype=env.dtype, device=obs.device)
    done = torch.zeros(G * seeds, dtype=torch.bool, device=obs.device)
    for t in range(T):
        states2, obs2, r, term, trunc = env.step(states, policy(rows, obs, t))
        states = _where(done, states, states2)
        obs = _where(done, obs, obs2)
        ret = ret + torch.where(done, torch.zeros_like(r), r)
        done = done | term | trunc
    return (ret.cpu().numpy().reshape(G, seeds),
            states.t.cpu().numpy().reshape(G, seeds))


def report(name, grid, rets, lens, seeds, T):
    """The family's lines: the top 5 by mean return, then its best."""
    mean_r = rets.mean(axis=1)
    surv = (lens >= T).mean(axis=1)
    order = np.argsort(-mean_r)
    lines = [f"--- {name}: top 5 of {len(grid)} (mean over {seeds} seeds; "
             f"horizon {T}) ---"]
    for i in order[:5]:
        lines.append(f"  params={tuple(round(float(x), 3) for x in grid[i])}"
                     f"  ret={mean_r[i]:7.1f}  "
                     f"survival={100 * surv[i]:5.1f}%")
    best = order[0]
    lines.append(f"[{name}] best ret={mean_r[best]:.1f} (>=900: "
                 f"{'YES' if mean_r[best] >= REGISTERED else 'no'}) "
                 f"params={tuple(float(x) for x in grid[best])}")
    return lines


def run(args):
    """The probe for parsed `args`. Returns {family: (returns (G, S),
    lengths (G, S))}."""
    device = resolve_device(args.device)
    env = brt.make("EnvMove05-v1", device=device)
    env.use_fast_solver()
    T = args.max_steps or env.max_episode_steps
    out = {}
    for name, policy, grid in FAMILIES:
        rets, lens = rollout(env, policy, grid, args.seeds, T)
        out[name] = (rets, lens)
        for line in report(name, grid, rets, lens, args.seeds, T):
            print(line)
    return out


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and probe."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
