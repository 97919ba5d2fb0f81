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
the batch. `launch_config(dtype, B)` reads the choice from the library
(`k2_launch_config`), and the launch passes it on; there is no other way
in.

The kernel is built at first use by `kernel_build.py` (nvcc, ctypes).
"""

import functools

import torch

from . import block_step as bs
from . import cuda_step
from . import kernel_build
from ..utils import profiling

LABEL, SOURCE = "k2", "control_step14.cu"    # library label, file in csrc/

# kernel launches since import (or since a caller reset it to 0), and the
# same by the team (lanes per env) that each launch took
launches = 0
launches_by_team = {}
# filled by build(): seconds, whether the library was reused, ptxas report
build_info = {}
_lib = None


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
    import ctypes
    ContactP, Params = cuda_step._params_struct()

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
        robot=cuda_step.kernel_params(p),
        block_floor=cuda_step.contact_params(bs.BLOCK_FLOOR),
        block_chassis=cuda_step.contact_params(bs.BLOCK_CHASSIS),
        block_wheel=cuda_step.contact_params(bs.BLOCK_WHEEL),
        block_mass=bs.BLOCK_MASS, block_inertia=bs.BLOCK_I,
        block_half=bs.BLOCK_HALF[0], block_margin=bs.BLOCK_MARGIN)


# ------------------------------------------------------------ build / load

def _bind(path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    P = ctypes.POINTER(_params_struct())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("k2_control_step_f32", "k2_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ptr] * 7 + [i32, P] + [i32] * 4 + [ptr]
            fn.restype = i32
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.k2_count_ops.argtypes = [dptr] * 7 + [P] + [i32] * 3 \
        + [ctypes.POINTER(ctypes.c_longlong)]
    lib.k2_count_ops.restype = ctypes.c_longlong
    for name in ("k2_crossover", "k2_mid_crossover"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.k2_launch_config.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.k2_launch_config.restype = None
    return lib


def build(process=None):
    """Build K2 if its sources changed, load it, and return the library.
    `process` is a compile already started with `kernel_build.start_build`."""
    global _lib
    if _lib is None:
        with profiling.setup_span("kernel.load"):
            _lib = _bind(kernel_build.build(LABEL, SOURCE, build_info,
                                            process))
    return _lib


def crossover(lib=None):
    """The batch from which K2 runs its main path's team (the `.cu`
    header's BRT_K2_CROSSOVER)."""
    return (lib or build()).k2_crossover()


def mid_crossover(lib=None):
    """The batch from which K2 runs its middle team (the `.cu` header's
    BRT_K2_MID)."""
    return (lib or build()).k2_mid_crossover()


def launch_config(dtype, B, lib=None):
    """(lanes per env, envs per block, shared bytes per block) of the
    instantiation that a launch of B envs of `dtype` (torch.float32 or
    torch.float64) takes. `lib`: as for `count_ops`."""
    return cuda_step.read_launch_config(
        (lib or build()).k2_launch_config, dtype, B)


# ------------------------------------------------------------ launch

def control_step14_cuda(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """Launch K2 on the current stream, with the instantiation that
    `launch_config` names for the batch; CUDA tensors only."""
    global launches
    B = qpos.shape[0]
    cuda_step.check_kernel_args("K2", qpos, [
        ("qpos", qpos, (B, 16)), ("qvel", qvel, (B, 14)),
        ("ws", ws, (B, 14)), ("ctrl", ctrl, (B, 2))])
    qp, qv, w = (torch.empty_like(t) for t in (qpos, qvel, ws))
    if B == 0:
        return qp, qv, w
    lib = build()
    fn = (lib.k2_control_step_f32 if qpos.dtype == torch.float32
          else lib.k2_control_step_f64)
    team = launch_config(qpos.dtype, B, lib)[0]
    import ctypes
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        with kernel_build.first_launch(f"{fn.__name__}/{team}"):
            err = fn(qpos.data_ptr(), qvel.data_ptr(), ws.data_ptr(),
                     ctrl.data_ptr(), qp.data_ptr(), qv.data_ptr(),
                     w.data_ptr(), B, ctypes.byref(kernel_params(params)),
                     params.newton_iters, params.ls_iters, frame_skip, team,
                     stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    launches += 1
    launches_by_team[team] = launches_by_team.get(team, 0) + 1
    return qp, qv, w


def count_ops(qpos, qvel, ws, ctrl, params, frame_skip=250, lib=None,
              coupled=None):
    """Run K2's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `_bind` (the source compiled as plain C++); by default the
    nvcc build. A list `coupled` receives, per env, the Newton steps that
    factorized H as 14 x 14 because a robot-block row was active."""
    import ctypes
    lib = lib or build()
    kp = kernel_params(params)
    dptr = ctypes.POINTER(ctypes.c_double)
    n_coupled = ctypes.c_longlong()
    counts = []
    outs = [torch.empty(qpos.shape[0], n, dtype=torch.float64)
            for n in (16, 14, 14)]
    for i in range(qpos.shape[0]):
        ins = [t[i].detach().to("cpu", torch.float64).contiguous()
               for t in (qpos, qvel, ws, ctrl)]
        counts.append(lib.k2_count_ops(
            *(ctypes.cast(t.data_ptr(), dptr) for t in ins),
            *(ctypes.cast(o[i].data_ptr(), dptr) for o in outs),
            ctypes.byref(kp), params.newton_iters, params.ls_iters,
            frame_skip, ctypes.byref(n_coupled)))
        if coupled is not None:
            coupled.append(n_coupled.value)
    return (counts, *outs)
