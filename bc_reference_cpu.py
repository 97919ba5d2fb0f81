"""The JAX package's behavior-cloning figure on the CPU, for `chip_smoke.py`.

Usage: JAX_PLATFORMS=cpu python bc_reference_cpu.py [--seed 0] \
           [--episodes 64] [--steps 400] [--out bc_init.npz]

Runs what `python -m balance_robot_tpu.cli -a PPO bc-init -e Env01-v2`
runs at its defaults (BCConfig with gamma 0.999 and log_std -1.0: 256
expert episodes x 400 steps at the exact grade, then 2000 Adam steps),
then evaluates the cloned policy deterministically with the JAX package's
ChunkedEvaluator over `--episodes` fresh Env01-v2 episodes of `--steps`
steps at the fast grade, the protocol of `chip_smoke.py` phase 8c. Prints
the survival share (episodes that reach `--steps`), its standard error and
the mean return. A run takes several minutes on a few CPU cores.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np
import jax
import jax.numpy as jnp

import balance_robot_tpu as brt
from balance_robot_tpu.models import mlp
from balance_robot_tpu.train import bc, checkpoint
from balance_robot_tpu.train.evaluation import ChunkedEvaluator

p = argparse.ArgumentParser()
p.add_argument("--seed", type=int, default=0)
p.add_argument("--episodes", type=int, default=64)
p.add_argument("--steps", type=int, default=400)
p.add_argument("--out", default=None, help="save the cloned params (npz)")
args = p.parse_args()

t0 = time.time()
params = bc.fit(brt.make("Env01-v2"),
                bc.BCConfig(gamma=0.999, log_std=-1.0),
                jax.random.PRNGKey(args.seed), verbose=True)
print(f"bc-init in {time.time() - t0:.1f} s", flush=True)
if args.out:
    checkpoint.save(args.out, params)

env = brt.make("Env01-v2")
env.use_fast_solver()
ev = ChunkedEvaluator(
    env, lambda p, o: jnp.clip(mlp.policy_mean(p, o), -1.0, 1.0))
t0 = time.time()
rets, lens = ev.evaluate_detail(
    params, jax.random.split(jax.random.PRNGKey(args.seed + 1),
                             args.episodes), args.steps)
alive = lens >= args.steps
se = float(np.sqrt(alive.mean() * (1 - alive.mean()) / args.episodes))
print(f"seed {args.seed}: {args.episodes} Env01-v2 episodes of {args.steps} "
      f"steps, fast grade, in {time.time() - t0:.1f} s: survival "
      f"{alive.mean():.4f} (s.e. {se:.4f}), mean return {rets.mean():.3f}, "
      f"mean length {lens.mean():.1f}")
