"""EnvMove05-v1 serving figures of the JAX package on the CPU, in float32.

Usage: python tools/move_reference_cpu.py --seed 7 --lo 0 --hi 32 \
           [--products bf16] [--solver fast] --out part0.npz
       python tools/move_reference_cpu.py --pool part*.npz

Runs episodes lo..hi of the `--episodes` deterministic episodes that
`tools/eval_policy.py MODEL --env EnvMove05-v1 --seed S` evaluates (the same
keys, so the same start states, as `runs/move_r5_pooled.log` for seeds 7 and
101), through the same `ChunkedEvaluator`, on the XLA physics path. A slice
is slow on a CPU, so a 256-episode evaluation is made as 8 processes of 32
episodes (about 25 minutes when they run side by side on 8 cores) and
pooled with `--pool`; `runs/move_cpu_reference.log` holds the lines these
commands printed for seeds 7 and 101.

On the CPU a float32 matrix product keeps its operands in float32. Where the
backend's default precision rounds them to bfloat16 first, the same policy
acts differently at the 3rd digit of its output, and the as-built reward
divides by 20 x the policy's previous output (docs/TRAINING.md), so the mean
return moves with it. `--products bf16` rounds the operands of the policy's
three products that way and leaves everything else as it is: the two
readings bracket what a float32 port of the serving path should return.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

p = argparse.ArgumentParser()
p.add_argument("--model", default="models/EnvMove05-v1_PPO_r4/best_model.npz")
p.add_argument("--seed", type=int, default=7)
p.add_argument("--episodes", type=int, default=256)
p.add_argument("--lo", type=int, default=0)
p.add_argument("--hi", type=int, default=None)
p.add_argument("--chunk", type=int, default=25)
p.add_argument("--products", choices=["float32", "bf16"], default="float32")
p.add_argument("--solver", choices=["exact", "fast"], default="exact")
p.add_argument("--out", default=None)
p.add_argument("--pool", nargs="+", default=None)
args = p.parse_args()

if args.pool:
    groups = {}
    for d in (np.load(f) for f in sorted(args.pool)):
        for seed in (int(d["seed"]), "all"):
            key = (str(d["products"]), str(d["solver"]), str(seed))
            groups.setdefault(key, []).append(d)
    for (products, solver, seed), ds in sorted(groups.items()):
        ret = np.concatenate([d["ret"] for d in ds])
        lens = np.concatenate([d["lens"] for d in ds])
        print(f"products {products:8s} solver {solver:5s} seed {seed:>4s} "
              f"n={ret.size:4d}  return mean {ret.mean():8.2f} "
              f"(s.e. {ret.std(ddof=1) / np.sqrt(ret.size):.2f}, median "
              f"{np.median(ret):.2f})  len mean {lens.mean():6.1f}  "
              f"full-horizon {100 * (lens >= 700).mean():5.2f}%")
    sys.exit(0)

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

import balance_robot_tpu as brt
from balance_robot_tpu.models import mlp
from balance_robot_tpu.train import checkpoint as ckpt
from balance_robot_tpu.train import evaluation

env = brt.make("EnvMove05-v1")
if args.solver == "fast":
    env.use_fast_solver()
params = ckpt.load(args.model)


def bf16_operands(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def policy_mean_bf16(q, o):
    h = o
    for layer in ("1", "2"):
        h = jnp.tanh(bf16_operands(h) @ bf16_operands(q[f"pi_w{layer}"])
                     + q[f"pi_b{layer}"])
    return bf16_operands(h) @ bf16_operands(q["pi_wout"]) + q["pi_bout"]


mean_fn = mlp.policy_mean if args.products == "float32" else policy_mean_bf16
ev = evaluation.ChunkedEvaluator(
    env, lambda q, o: jnp.clip(mean_fn(q, o), -1.0, 1.0), chunk=args.chunk)
keys = jax.random.split(jax.random.PRNGKey(args.seed),
                        args.episodes)[args.lo:args.hi]
ret, lens = ev.evaluate_detail(params, keys)
print(f"EnvMove05-v1 {args.model} seed {args.seed} episodes "
      f"{args.lo}..{args.lo + len(ret)} of {args.episodes}, products "
      f"{args.products}, solver {args.solver}, {jax.default_backend()}: "
      f"return mean {ret.mean():.2f}, len mean {lens.mean():.1f}, "
      f"full-horizon {100 * (lens >= env.max_episode_steps).mean():.2f}%")
if args.out:
    np.savez(args.out, ret=ret, lens=lens, seed=args.seed, lo=args.lo,
             products=args.products, solver=args.solver)
