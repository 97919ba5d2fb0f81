"""balance_robot_tpu_torch: the balance-robot system in PyTorch and CUDA.

A port of `balance_robot_tpu` (JAX) that keeps its module layout. The env
registry uses the reference's Gymnasium ids; this package registers the
ids it has ported.
"""

import torch

_REGISTRY = {}


def register(env_id, factory):
    _REGISTRY[env_id] = factory


def make(env_id, device=None, dtype=torch.float32, seed=0):
    """Create a batched env by its reference-compatible id.

    Runs on CUDA unless `device` names another device; raises when no GPU
    is present and the CPU was not asked for."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[env_id](device=device, dtype=dtype, seed=seed)


def env_ids():
    return sorted(_REGISTRY)


def _populate():
    from .envs.env01 import Env01V1, Env01V2, Env01V3
    from .envs.env02 import Env02V1
    from .envs.env03 import Env03V1, Env03V2, Env03V1Fail
    for cls in (Env01V1, Env01V2, Env01V3, Env02V1, Env03V1, Env03V2,
                Env03V1Fail):
        register(cls.id, cls)


_populate()
