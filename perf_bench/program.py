"""Building the system under test from a cell's files, and the run's seeds.

The port (`balance_robot_tpu_torch`) is imported here, in the drivers and
in `faults.py` only. From it the benchmark takes the system under test (its
envs, policy, trainer, evaluator and CLI loop); the profiler gives its
kernels' names.
"""

from dataclasses import replace
from types import SimpleNamespace

import torch

ROOT_SEED_MIX = 1_000_003


def derive(seed, tag):
    """An independent seed for stream `tag` of a run seeded with `seed`."""
    return (seed * ROOT_SEED_MIX + tag) % (2 ** 63)


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_env(ctx, seed):
    """The cell's env on its device at the cell's solver grade
    (`core.grade_name`, `core.solver`), its generator seeded with
    `seed`."""
    import balance_robot_tpu_torch as brt
    from . import core
    env = brt.make(ctx.config["env_id"], device=ctx.device,
                   dtype=getattr(torch, ctx.config["dtype"]), seed=seed)
    settings = core.solver(core.grade_name(ctx.traffic, ctx.config))
    if settings:
        env.params = replace(env.params, **settings)
    return env


def reference_env(ctx, env_id):
    """The plain reference of `env_id` (`reference/envs/<env_id>.py`) at
    the cell's solver grade."""
    from . import core
    from .reference import envs
    return envs.load(env_id)(core.solver(core.grade_name(ctx.traffic,
                                                          ctx.config)))


def policy_path(config):
    from .core import ROOT
    return ROOT / config["policy"]


def load_params(config):
    """The config's policy checkpoint as the port loads it (numpy dict)."""
    from balance_robot_tpu_torch.train import checkpoint
    return checkpoint.load(str(policy_path(config)))


def context(args, entry, traffic, config, device):
    """What a driver is handed: the run's arguments, the cell's files and
    the device ("cuda" in every run; "cpu" only in the CPU tests)."""
    return SimpleNamespace(seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), cell=entry,
                           traffic=traffic, config=config, device=device,
                           control=False)
