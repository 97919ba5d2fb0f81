"""Large-scale deterministic policy evaluation, split by recoverable starts.

Counterpart of `tools/eval_policy.py`. Runs `--episodes` deterministic
episodes from `--seed` (`selection.paired_eval`) of the checkpoint, by its
format (`selection.act_fn_for`: PPO / A2C, SAC, TD3, DDPG, a privileged-obs
teacher through `PrivilegedObsEnv`, or the int8 deployment path with
`--int8`), at the env's registered solver grade, and reports return and
length statistics over all starts and split by recoverable starts:
|pitch at t = 0| below the 50 degree termination bound, read from the same
reset that the evaluator steps (the reference reset puts about 13% of
Env01-v2's episodes beyond it, which no policy can save). `--dump` writes
the per-episode `ret`, `lens`, `p0` and `seed` as npz.

Run:  python -m balance_robot_tpu_torch.train.eval_policy MODEL.npz \\
          [--env Env01-v2] [--episodes 256] [--int8] [--device cpu]
"""

import argparse

import numpy as np

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.base import TERMINATE_PITCH, pitch_of
from . import checkpoint as ckpt
from . import selection


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.eval_policy",
        description="Large-scale deterministic policy evaluation.")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env01-v2")
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--dump", default=None,
                    help="npz path for per-episode (return, length, start "
                         "pitch) arrays")
    ap.add_argument("--int8", action="store_true",
                    help="run the checkpoint through the int8 deployment "
                         "path (post-training quantization + integer "
                         "inference)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the env and the policy run (default: the "
                         "GPU; raises without one)")
    return ap


def main(argv=None):
    """Run the evaluation; returns (rets, lens, start pitches) as numpy
    arrays."""
    args = build_parser().parse_args(argv)
    registered = brt.make(args.env, device=resolve_device(args.device))
    env, act, policy = selection.act_fn_for(ckpt.load(args.model),
                                            registered, int8=args.int8)
    if env is not registered:
        print(f"[teacher checkpoint: evaluating through PrivilegedObsEnv "
              f"({env.obs_dim}-obs)]")
    if args.int8:
        print("[int8 deployment path]")
    max_steps = env.max_episode_steps
    starts = []
    _, _, _, ret, lens = selection.paired_eval(
        env, act, policy, args.seed, args.episodes, max_steps, args.chunk,
        on_start=lambda states, obs: starts.append(
            pitch_of(states.phys.qpos)))
    p0 = starts[0].cpu().numpy()
    recoverable = np.abs(p0) < TERMINATE_PITCH
    if args.dump:
        np.savez(args.dump, ret=ret, lens=lens, p0=p0, seed=args.seed)
        print(f"per-episode arrays -> {args.dump}")
    print(f"{args.env}  {args.model}  ({args.episodes} deterministic "
          f"episodes, horizon {max_steps})")
    for name, m in (("all", np.ones_like(recoverable)),
                    ("recoverable starts", recoverable),
                    ("unrecoverable starts", ~recoverable)):
        if m.sum() == 0:
            continue
        full = (lens[m] >= max_steps).mean()
        print(f"  {name:22s} n={int(m.sum()):4d}  return mean "
              f"{ret[m].mean():8.1f}  len mean {lens[m].mean():6.0f} median "
              f"{np.median(lens[m]):6.0f}  full-horizon {100 * full:5.1f}%")
    return ret, lens, p0


if __name__ == "__main__":
    main()
