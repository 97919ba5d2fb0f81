"""Sweep every checkpoint of a run with a large deterministic eval and rank
by full-horizon survival.

Counterpart of `tools/sweep_checkpoints.py`. The runner gates
`best_model` on a small eval, which is noisy at the flagship's margins;
this evaluates `cp_*.npz` in step order (every `--every`-th) and then
`best_model`, `longest_model` and `final_model` on one paired set of
`--episodes` episodes from `--seed` (`selection.paired_eval`, the
training-grade solver), ranks them by (full-horizon rate, mean length) and
writes the ranked rows to `--out` as JSON with the tool's keys.

Run:  python -m balance_robot_tpu_torch.train.sweep models/Env03-v2_r2a \\
          [--env Env03-v2] [--episodes 256] [--out sweep.json] \\
          [--device cpu]
"""

import argparse
import json
import pathlib

import numpy as np

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from . import checkpoint as ckpt
from . import selection

NAMED = ("best_model", "longest_model", "final_model")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.sweep",
        description="Rank a run's checkpoints by a large paired eval.")
    ap.add_argument("run_dir")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--every", type=int, default=1,
                    help="evaluate every Nth numbered checkpoint")
    ap.add_argument("--out", default=None,
                    help="write ranked results as JSON")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the policies run (default: "
                         "the GPU; raises without one)")
    return ap


def checkpoints(run, every=1):
    """The run's `cp_*.npz` in step order, every `every`-th, then its named
    checkpoints, those that exist."""
    run = pathlib.Path(run)
    numbered = sorted(run.glob("cp_*.npz"),
                      key=lambda p: int(p.stem.split("_")[1]))[::every]
    named = [run / f"{n}.npz" for n in NAMED]
    return [p for p in numbered + named if p.exists()]


def main(argv=None):
    """Run the sweep; returns the ranked rows."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device).use_fast_solver()
    max_steps = env.max_episode_steps
    paths = checkpoints(args.run_dir, args.every)
    print(f"{len(paths)} checkpoints, {args.episodes} episodes each, "
          f"horizon {max_steps} ({device.type})", flush=True)
    rows = []
    for p in paths:
        ev_env, act, policy = selection.act_fn_for(ckpt.load(p), env)
        full, ret, length, _, lens = selection.paired_eval(
            ev_env, act, policy, args.seed, args.episodes, max_steps,
            args.chunk)
        rows.append(dict(ckpt=p.name, full_horizon=full, mean_return=ret,
                         mean_len=length, median_len=float(np.median(lens))))
        print(f"  {p.name:24s} full={100 * full:5.1f}%  "
              f"ret={ret:8.1f}  len={length:6.0f}", flush=True)
    rows.sort(key=lambda r: (r["full_horizon"], r["mean_len"]), reverse=True)
    print("\nbest:", rows[0])
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
