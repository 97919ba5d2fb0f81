"""balance_robot_tpu_torch: the balance-robot system in PyTorch and CUDA.

A port of `balance_robot_tpu` (JAX) that keeps its module layout. The env
registry uses the reference's Gymnasium ids, all nine of them. The import
is the set-up span `setup.import` (`utils/profiling.setup_span`), from the
first line of this file to the end of `_populate()`.
"""

import time

_IMPORT_START_NS = time.perf_counter_ns()

import torch  # noqa: E402

from .utils import profiling  # noqa: E402

_REGISTRY = {}


def register(env_id, factory):
    _REGISTRY[env_id] = factory


def env_class(env_id):
    """The registered factory (the env's class) of `env_id`: its class
    attributes (obs_dim, act_dim, max_episode_steps) without building an
    env or touching a device."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[env_id]


def make(env_id, device=None, dtype=torch.float32, seed=0):
    """Create a batched env by its reference-compatible id.

    Runs on CUDA unless `device` names another device; raises when no GPU
    is present and the CPU was not asked for."""
    return env_class(env_id)(device=device, dtype=dtype, seed=seed)


def env_ids():
    return sorted(_REGISTRY)


def _populate():
    from .envs.env01 import Env01V1, Env01V2, Env01V3
    from .envs.env02 import Env02V1
    from .envs.env03 import Env03V1, Env03V2, Env03V1Fail
    from .envs.cal01 import Cal01
    from .envs.move import EnvMove05
    for cls in (Env01V1, Env01V2, Env01V3, Env02V1, Env03V1, Env03V2,
                Env03V1Fail, Cal01, EnvMove05):
        register(cls.id, cls)


with profiling.setup_span("setup.import", start_ns=_IMPORT_START_NS):
    _populate()
