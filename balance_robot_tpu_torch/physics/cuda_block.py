"""K2: the fused 250-substep control step of the 14-dof robot + block scene,
as a CUDA kernel for Hopper.

Replaces `balance_robot_tpu/physics/pallas_block.py::_kernel14`. The kernel
source is `csrc/control_step14.cu` (with `csrc/robot_common.cuh`, shared
with K1, and `csrc/box_collide.cuh`); its plain PyTorch version is
`block_step.control_step14`, wrapped here as `control_step14_plain` with
the kernel's signature.

`control_step14(qpos, qvel, ws, ctrl, params)` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors: the device of the
state decides, and a CUDA call that cannot build or launch raises.

The one source holds three instantiations of the kernel, and the batch
size picks one, at the crossovers that the `.cu` header names: below the
first (evals, B = 1), a team of 32 lanes per env, one env per warp; from
it to the second (training collects, the MPC expert's plan rollouts), a
team of 16 lanes, 2 envs per warp; from the second on (the 4096-env main
path, the oracle's generations), a team of 8 lanes, 4 envs per warp. All
take their row sums as 32 lanes would, so an env's bits do not depend on
the batch. `KERNEL.launch_config(dtype, B)` reads the choice from the
library (`k2_launch_config`), and the launch passes it on; there is no
other way in.

`KERNEL` (`cuda_kernel.Kernel`) holds the library, its launch shapes and
crossovers, and the launch counts; the kernel is built at first use by
`kernel_build.py` (nvcc, ctypes).
"""

import ctypes
import functools

from . import block_step as bs
from . import cuda_kernel as ck

LABEL, SOURCE = "k2", "control_step14.cu"    # library label, file in csrc/


def _type_entries(lib):
    """Type K2's launch entries (an nvcc build's) and count entry."""
    P = ctypes.POINTER(_params_struct())
    for name in ("k2_control_step_f32", "k2_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ck.PTR] * 7 + [ck.I32, P] + [ck.I32] * 4 \
                + [ck.PTR]
            fn.restype = ck.I32
    lib.k2_count_ops.argtypes = [ck.DPTR] * 7 + [P] + [ck.I32] * 3 \
        + [ctypes.POINTER(ctypes.c_longlong)]
    lib.k2_count_ops.restype = ctypes.c_longlong


KERNEL = ck.Kernel("K2", LABEL, SOURCE, ("k2_mid_crossover", "k2_crossover"),
                   _type_entries)


def control_step14_plain(qpos, qvel, ws, ctrl, params, frame_skip=250,
                         contact_counts=None):
    """The plain PyTorch version: K2's arithmetic one tensor op at a time.
    `contact_counts`: see `block_step.control_step14`."""
    s = bs.control_step14(bs.PhysState14(qpos, qvel, ws), ctrl, params,
                          frame_skip=frame_skip,
                          contact_counts=contact_counts)
    return s.qpos, s.qvel, s.warmstart


def control_step14(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """One control step of B envs: qpos (B,16), qvel (B,14), ws (B,14),
    ctrl (B,2) -> (qpos', qvel', ws').

    CUDA tensors launch K2; CPU tensors take the plain version."""
    if qpos.is_cuda:
        return control_step14_cuda(qpos, qvel, ws, ctrl, params, frame_skip)
    return control_step14_plain(qpos, qvel, ws, ctrl, params, frame_skip)


# ------------------------------------------------------------ parameters

@functools.lru_cache(maxsize=None)
def _params_struct():
    """The ctypes mirror of the kernel's Params14 struct."""
    ContactP, Params = ck.params_struct()

    class Params14(ctypes.Structure):
        _fields_ = [("robot", Params), ("block_floor", ContactP),
                    ("block_chassis", ContactP), ("block_wheel", ContactP)] \
            + [(n, ctypes.c_double) for n in (
                "block_mass", "block_inertia", "block_half", "block_margin")]
    return Params14


def kernel_params(p):
    """The kernel's Params14 struct for RobotSceneParams `p` and the block
    constants of `block_step`, every derived constant evaluated in double."""
    return _params_struct()(
        robot=ck.kernel_params(p),
        block_floor=ck.contact_params(bs.BLOCK_FLOOR),
        block_chassis=ck.contact_params(bs.BLOCK_CHASSIS),
        block_wheel=ck.contact_params(bs.BLOCK_WHEEL),
        block_mass=bs.BLOCK_MASS, block_inertia=bs.BLOCK_I,
        block_half=bs.BLOCK_HALF[0], block_margin=bs.BLOCK_MARGIN)


# ------------------------------------------------------------ launch

def control_step14_cuda(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """Launch K2 on the current stream, with the instantiation that
    `KERNEL.launch_config` names for the batch; CUDA tensors only."""
    B = qpos.shape[0]
    return KERNEL.launch([("qpos", qpos, (B, 16)), ("qvel", qvel, (B, 14)),
                          ("ws", ws, (B, 14)), ("ctrl", ctrl, (B, 2))],
                         kernel_params(params), params, frame_skip)


def count_ops(qpos, qvel, ws, ctrl, params, frame_skip=250, lib=None,
              coupled=None, sections=None):
    """Run K2's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `KERNEL.bind` (the source compiled as plain C++); by default
    the nvcc build. A list `coupled` receives, per env, the Newton steps
    that factorized H as 14 x 14 because a robot-block row was active; a
    list `sections` each env's operations by section of the chain, its
    rows and coupled steps (`Kernel.count_ops`)."""
    kp = kernel_params(params)
    n_coupled = ctypes.c_longlong()

    def count_one(entry, i, ins, outs):
        n = entry(*ins, *outs, ctypes.byref(kp), params.newton_iters,
                  params.ls_iters, frame_skip, ctypes.byref(n_coupled))
        if coupled is not None:
            coupled.append(n_coupled.value)
        return n
    return KERNEL.count_ops((qpos, qvel, ws, ctrl), count_one, lib,
                            sections)
