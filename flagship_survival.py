"""Full-horizon survival of the flagship policy through the port, on the GPU.

Usage: python flagship_survival.py [--draws 4] [--episodes 1024] \
           [--seed 5001] [--model models/Env03-v2_r2i/best_model.npz]

Evaluates the deterministic policy (`clip(policy_mean)`) over `--draws`
batches of `--episodes` fresh Env03-v2 episodes at the exact solver grade
over the full 1200-step horizon, through `balance_robot_tpu_torch`'s
ChunkedEvaluator (K2 on the card), each draw from its own env seed
(`--seed`, `--seed` + 1, ...). Prints each draw's survival and seconds and
the pooled survival with its standard error, beside the card's name and
power limit. The JAX package's band for this policy is 84-92% (89.5%
pooled over 1,024 episodes, README). About 80 s per draw of 1,024 on one
H100.
"""
import argparse
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint
from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
from balance_robot_tpu_torch.train.ppo import deterministic_action

p = argparse.ArgumentParser()
p.add_argument("--model", default="models/Env03-v2_r2i/best_model.npz")
p.add_argument("--draws", type=int, default=4)
p.add_argument("--episodes", type=int, default=1024)
p.add_argument("--seed", type=int, default=5001)
args = p.parse_args()

if not torch.cuda.is_available():
    sys.exit("flagship_survival: needs a GPU")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
net = mlp.from_numpy_params(checkpoint.load(args.model), device="cuda")
alive = []
for d in range(args.draws):
    env = brt.make("Env03-v2", seed=args.seed + d)
    t0 = time.perf_counter()
    rets, lens = ChunkedEvaluator(env, deterministic_action).evaluate_detail(
        net, args.episodes)
    seconds = time.perf_counter() - t0
    ok = lens >= env.max_episode_steps
    alive.append(ok)
    print(f"draw {d} (env seed {args.seed + d}): {args.episodes} episodes "
          f"of {env.max_episode_steps} steps, exact grade, in {seconds:.1f} "
          f"s: survival {ok.mean():.4f}, mean return {rets.mean():.2f}, "
          f"mean length {lens.mean():.1f}", flush=True)
pooled = np.concatenate(alive)
share = pooled.mean()
se = np.sqrt(share * (1 - share) / pooled.size)
print(f"pooled over {pooled.size} episodes: survival {share:.4f} (s.e. "
      f"{se:.4f}); draws {[round(float(a.mean()), 4) for a in alive]}; the "
      f"JAX package's band 0.84-0.92")
