"""K3: the fused 250-substep control step of the 8-dof robot between static
walls (the corridor of EnvMove05), as a CUDA kernel for Hopper.

Replaces `balance_robot_tpu/physics/pallas_move.py::_kernel_walls`. The
kernel source is `csrc/control_step_walls.cu` (with `csrc/robot_common.cuh`,
shared with K1 and K2, and `csrc/box_collide.cuh`, shared with K2); its
plain PyTorch version is the wall scene of `step.control_step`, wrapped
here as `control_step_walls_plain` with the kernel's signature.

`control_step_walls(qpos, qvel, ws, ctrl, params)` launches the kernel for
CUDA tensors and runs the plain version for CPU tensors: the device of the
state decides, and a CUDA call that cannot build or launch raises.
`cuda_step.control_step`, which the envs call, sends a scene with walls
here.

The one source holds two instantiations of the kernel on the team solver
of K1 and K2, and the batch size picks one: below the crossover that the
`.cu` header names (serving batches), a team of 32 lanes per env with its
rows in shared memory; from it on (the 4096-env main path), one thread per
env with its rows in its own local array. `KERNEL.launch_config(dtype, B)`
reads the choice from the library (`k3_launch_config`), and the launch
passes it on; there is no other way in.

`KERNEL` (`cuda_kernel.Kernel`) holds the library, its launch shapes and
crossovers, and the launch counts; the kernel is built at first use by
`kernel_build.py` (nvcc, ctypes).
"""

import ctypes
import functools

from . import cuda_kernel as ck
from . import step as st

LABEL, SOURCE = "k3", "control_step_walls.cu"   # library label, file in csrc/
MAX_WALLS = 4                                   # the kernel's ParamsWalls


def _type_entries(lib):
    """Check the walls the library holds, and type K3's launch entries (an
    nvcc build's) and count entries."""
    lib.k3_max_walls.argtypes = []
    lib.k3_max_walls.restype = ck.I32
    if lib.k3_max_walls() != MAX_WALLS:
        raise RuntimeError(f"{lib._name}: built for {lib.k3_max_walls()} "
                           f"walls, the wrapper for {MAX_WALLS}")
    P = ctypes.POINTER(_params_struct())
    for name in ("k3_control_step_f32", "k3_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ck.PTR] * 7 + [ck.I32, P] + [ck.I32] * 4 \
                + [ck.PTR]
            fn.restype = ck.I32
    for name in ("k3_count_ops", "k3_count_ops_team_rows"):
        fn = getattr(lib, name)
        fn.argtypes = [ck.DPTR] * 7 + [P] + [ck.I32] * 3
        fn.restype = ctypes.c_longlong


KERNEL = ck.Kernel("K3", LABEL, SOURCE, ("k3_crossover",), _type_entries)


def control_step_walls_plain(qpos, qvel, ws, ctrl, params, frame_skip=250,
                             contact_counts=None):
    """The plain PyTorch version: K3's arithmetic one tensor op at a time.
    `contact_counts`: see `step.control_step`."""
    s = st.control_step(st.PhysState(qpos, qvel, ws), ctrl, params,
                        frame_skip=frame_skip, contact_counts=contact_counts)
    return s.qpos, s.qvel, s.warmstart


def control_step_walls(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """One control step of B envs: qpos (B,9), qvel (B,8), ws (B,8),
    ctrl (B,2) -> (qpos', qvel', ws').

    CUDA tensors launch K3; CPU tensors take the plain version."""
    if qpos.is_cuda:
        return control_step_walls_cuda(qpos, qvel, ws, ctrl, params,
                                       frame_skip)
    return control_step_walls_plain(qpos, qvel, ws, ctrl, params, frame_skip)


# ------------------------------------------------------------ parameters

@functools.lru_cache(maxsize=None)
def _params_struct():
    """The ctypes mirror of the kernel's ParamsWalls struct."""
    ContactP, Params = ck.params_struct()

    class ParamsWalls(ctypes.Structure):
        _fields_ = [("robot", Params), ("wall_chassis", ContactP),
                    ("wall_wheel", ContactP), ("n_walls", ctypes.c_int),
                    ("walls", ctypes.c_double * 6 * MAX_WALLS)]
    return ParamsWalls


def kernel_params(p):
    """The kernel's ParamsWalls struct for RobotSceneParams `p`, every
    derived constant evaluated in double. Raises for more walls than the
    struct holds."""
    if len(p.walls) > MAX_WALLS:
        raise ValueError(f"K3 holds at most {MAX_WALLS} walls, the scene has "
                         f"{len(p.walls)}")
    ch_prm, w_prm = st.wall_contact_params(p.wall_contact)
    kp = _params_struct()(
        robot=ck.kernel_params(p),
        wall_chassis=ck.contact_params(ch_prm),
        wall_wheel=ck.contact_params(w_prm), n_walls=len(p.walls))
    for i, (center, half) in enumerate(p.walls):
        kp.walls[i][:] = (*center, *half)
    return kp


# ------------------------------------------------------------ launch

def control_step_walls_cuda(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """Launch K3 on the current stream, with the instantiation that
    `KERNEL.launch_config` names for the batch; CUDA tensors only."""
    B = qpos.shape[0]
    return KERNEL.launch([("qpos", qpos, (B, 9)), ("qvel", qvel, (B, 8)),
                          ("ws", ws, (B, 8)), ("ctrl", ctrl, (B, 2))],
                         kernel_params(params), params, frame_skip)


def count_ops(qpos, qvel, ws, ctrl, params, frame_skip=250, lib=None,
              sections=None):
    """Run K3's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `KERNEL.bind` (the source compiled as plain C++); by default
    the nvcc build. A list `sections` receives each env's operations by
    section of the chain, its rows and coupled steps (`Kernel.count_ops`)."""
    kp = kernel_params(params)

    def count_one(entry, i, ins, outs):
        return entry(*ins, *outs, ctypes.byref(kp), params.newton_iters,
                     params.ls_iters, frame_skip)
    return KERNEL.count_ops((qpos, qvel, ws, ctrl), count_one, lib,
                            sections)
