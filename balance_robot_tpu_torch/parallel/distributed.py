"""Multi-rank initialization on `torch.distributed`.

Counterpart of `balance_robot_tpu/parallel/distributed.py`. One call per
process, before any CUDA allocation:

    from balance_robot_tpu_torch.parallel import distributed
    distributed.initialize()          # no-op in a one-process run
    mesh = distributed.global_env_mesh()
    runner.train(env, cfg, mesh=mesh)

`torchrun --nproc_per_node=N script.py` exports what the default `env://`
rendezvous reads (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`); explicit kwargs (`init_method=`, `world_size=`, `rank=`)
pass through to `torch.distributed.init_process_group` for other launchers.

The decision comes from the environment only, as in the JAX module:
`BRT_MULTIHOST` forces the call, or disables it with "", "0", "false" or
"no"; without it, `WORLD_SIZE` > 1 with `MASTER_ADDR` set means a
multi-rank job. The backend is NCCL unless the caller asks for the CPU
(`device="cpu"`) or for gloo (`backend="gloo"`); nothing falls back from
one to the other.

Ordering is load-bearing, as in the JAX module (whose init must precede
the backend): a NCCL rank selects its card, `torch.cuda.set_device(
LOCAL_RANK)`, before `init_process_group` and before any CUDA allocation,
or every rank's context lands on `cuda:0`. A multi-rank environment that
fails to initialize raises; it is never downgraded to one process.
"""

import os

import torch
import torch.distributed as dist

from . import mesh as _mesh

_initialized = False

_FALSEY = ("", "0", "false", "no")


def _multirank_environment():
    forced = os.environ.get("BRT_MULTIHOST")
    if forced is not None:
        return forced.strip().lower() not in _FALSEY
    world = os.environ.get("WORLD_SIZE", "1").strip() or "1"
    return int(world) > 1 and bool(os.environ.get("MASTER_ADDR"))


def initialize(device=None, **kwargs):
    """Idempotent `torch.distributed.init_process_group`; a no-op for a
    one-process run.

    `device="cpu"` (or `backend="gloo"`) picks gloo, otherwise NCCL, whose
    rank first selects `cuda:<LOCAL_RANK>` (0 where it is not set). Other
    kwargs pass through (`init_method`, `world_size`, `rank`, ...). Raises
    whatever the initialization raises."""
    global _initialized
    if _initialized:
        return
    if kwargs or _multirank_environment():
        backend = kwargs.pop("backend", None) or (
            "gloo" if device is not None and torch.device(device).type == "cpu"
            else "nccl")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend=backend, **kwargs)
    _initialized = True


def is_initialized():
    return _initialized


def global_env_mesh(axis="env"):
    """The 1-D mesh over every rank of the job (one rank without one)."""
    return _mesh.make_mesh(axis=axis)


def is_coordinator():
    return not dist.is_initialized() or dist.get_rank() == 0
