"""Per-episode failure forensics for the Env03 block envs.

Counterpart of `tools/failure_forensics.py`, with its options, defaults,
output lines and `--dump` arrays. N deterministic episodes record, per
episode: its length and return, the attack side (read after reset), the
block launches it saw (reset fires the first), the step of its last
launch, and the pitch and pitch rate at failure (the rate a finite
difference over one control step, 0.005 s, of the true pitch). The lines
answer:

  * are failures concentrated on one attack side?
  * do they come right after a launch (an impact kill) or between
    launches (drift)?
  * at which hit count do they come?

A launch is the block back on its spawn circle (< 0.5 m) one step after
it was parked far away (> 2 m). The episodes reset from a copy of the env
seeded with `--seed` and run in chunks of `--chunk` steps (one host sync
per chunk); an episode that is done is frozen.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.failure_forensics \\
          MODEL.npz [--episodes 512] [--dump runs/forensics.npz]
"""

import argparse

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.base import CONTROL_DT, pitch_of
from ..models import mlp
from . import checkpoint as ckpt
from .harvest import _block_dist, _where
from .ppo import deterministic_action, fork_env

IMPACT_WINDOW = 40          # steps: 0.2 s after a launch
DEATH_BINS = [0, 150, 300, 450, 600, 750, 900, 1050, 1200]


def build_parser():
    """Every option and default of `tools/failure_forensics.py`, with
    `--device` in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.failure_forensics",
        description="Per-episode failure forensics for the Env03 envs.")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--episodes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the policy run (default: the "
                         "GPU; raises without one)")
    return ap


def start_carry(states, obs):
    """The rollout's carry after reset: (states, obs, ret, done, t,
    extras)."""
    n = obs.shape[0]
    dev = obs.device
    pitch = pitch_of(states.phys.qpos)
    ints = dict(dtype=torch.int32, device=dev)
    extras = dict(
        n_fires=torch.ones(n, **ints),          # reset fires the first block
        last_fire_t=torch.zeros(n, **ints),
        fail_pitch=torch.zeros_like(pitch),
        fail_pdot=torch.zeros_like(pitch),
        prev_pitch=pitch,
        prev_parked=torch.zeros(n, dtype=torch.bool, device=dev))
    return (states, obs, torch.zeros_like(pitch),
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros(n, **ints), extras)


@torch.no_grad()
def step(env, net, carry, uniforms=None):
    """One control step of every episode and its extras; `uniforms` (B, 6)
    replaces the launch draws."""
    states, obs, ret, done, t, ex = carry
    states2, obs2, r, term, trunc = env.step(
        states, deterministic_action(net, obs), uniforms)
    pitch2 = pitch_of(states2.phys.qpos)
    d2 = _block_dist(states2)
    fired = ex["prev_parked"] & (d2 < 0.5)
    alive = ~done
    new_fail = alive & term
    pdot = (pitch2 - ex["prev_pitch"]) / CONTROL_DT
    hit = fired & alive
    ex = dict(
        n_fires=ex["n_fires"] + hit.to(torch.int32),
        last_fire_t=torch.where(hit, t + 1, ex["last_fire_t"]),
        fail_pitch=torch.where(new_fail, pitch2, ex["fail_pitch"]),
        fail_pdot=torch.where(new_fail, pdot, ex["fail_pdot"]),
        prev_pitch=torch.where(alive, pitch2, ex["prev_pitch"]),
        prev_parked=torch.where(alive, d2 > 2.0, ex["prev_parked"]))
    return (_where(done, states, states2), _where(done, obs, obs2),
            ret + torch.where(done, torch.zeros_like(r), r),
            done | term | trunc, t + alive.to(torch.int32), ex)


@torch.no_grad()
def record(env, net, episodes, seed=0, chunk=250):
    """The per-episode arrays (numpy) of `episodes` deterministic episodes
    of a copy of `env` seeded with `seed`: lens, ret, n_fires, last_fire,
    fail_pitch, fail_pdot, attack_front."""
    max_steps = env.max_episode_steps
    env = fork_env(env, seed)
    states, obs = env.reset(episodes)
    attack_front = states.aux["attack_front"].cpu().numpy()
    carry = start_carry(states, obs)
    steps = 0
    while steps < max_steps:
        for _ in range(min(chunk, max_steps - steps)):
            carry = step(env, net, carry)
        steps += chunk
        if bool(carry[3].all()):
            break
    _, _, ret, _, lens, ex = carry
    return dict(lens=lens.cpu().numpy(), ret=ret.cpu().numpy(),
                n_fires=ex["n_fires"].cpu().numpy(),
                last_fire=ex["last_fire_t"].cpu().numpy(),
                fail_pitch=ex["fail_pitch"].cpu().numpy(),
                fail_pdot=ex["fail_pdot"].cpu().numpy(),
                attack_front=attack_front)


def report(rec, max_steps, title):
    """The tool's lines for the arrays of `record`; `title` leads the
    first."""
    lens, n_fires = rec["lens"], rec["n_fires"]
    attack_front = rec["attack_front"]
    full = lens >= max_steps
    failed = ~full

    def pct(mask):
        """A guarded percentage over a possibly empty slice (a small run
        can draw one attack side; a weak checkpoint can have no
        survivors)."""
        return f"{100 * full[mask].mean():.1f}%" if mask.any() else "n/a"

    lines = [f"{title}: n={len(lens)} full-horizon {100 * full.mean():.1f}%"
             f"  (front {pct(attack_front)} n={attack_front.sum()}, back "
             f"{pct(~attack_front)} n={(~attack_front).sum()})"]
    if failed.sum():
        dt_fail = lens[failed] - rec["last_fire"][failed]
        fail_pitch = rec["fail_pitch"][failed]
        full_fires = (f"~{np.median(n_fires[full]):.0f}" if full.any()
                      else "n/a")
        hist, edges = np.histogram(lens[failed], bins=DEATH_BINS)
        lines += [
            f"failures: {failed.sum()}",
            f"  hits survived (n_fires at death): min "
            f"{n_fires[failed].min()} med {np.median(n_fires[failed]):.0f} "
            f"max {n_fires[failed].max()}  (full-horizon episodes see "
            f"{full_fires})",
            f"  steps from last launch to death: min {dt_fail.min()} med "
            f"{np.median(dt_fail):.0f} p90 {np.percentile(dt_fail, 90):.0f} "
            f"max {dt_fail.max()}",
            f"  death pitch sign: +{(fail_pitch > 0).sum()} / "
            f"-{(fail_pitch < 0).sum()}   |pdot| med "
            f"{np.median(np.abs(rec['fail_pdot'][failed])):.1f} rad/s",
            f"  fraction dying within 0.2 s of a launch: "
            f"{100 * (dt_fail <= IMPACT_WINDOW).mean():.0f}%",
            "  death-time histogram (steps): " + str(
                {f"{edges[i]}-{edges[i + 1]}": int(hist[i])
                 for i in range(len(hist))})]
    return lines


def run(args):
    """The forensics for parsed `args`; returns the arrays of `record`."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device)
    env.use_fast_solver()
    net = mlp.from_numpy_params(ckpt.load(args.model), device=env.device,
                                dtype=env.dtype)
    rec = record(env, net, args.episodes, args.seed, args.chunk)
    for line in report(rec, env.max_episode_steps,
                       f"{args.env} {args.model}"):
        print(line)
    if args.dump:
        np.savez(args.dump, **rec)
        print(f"-> {args.dump}")
    return rec


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the forensics."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
