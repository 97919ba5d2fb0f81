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

The kernel is built at first use by `kernel_build.py` (nvcc, ctypes).
"""

import functools

import torch

from . import cuda_step
from . import kernel_build
from . import step as st

LABEL, SOURCE = "k3", "control_step_walls.cu"   # library label, file in csrc/
MAX_WALLS = 4                                   # the kernel's ParamsWalls

# kernel launches since import (or since a caller reset it to 0)
launches = 0
# filled by build(): seconds, whether the library was reused, ptxas report
build_info = {}
_lib = None


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
    import ctypes
    ContactP, Params = cuda_step._params_struct()

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
        robot=cuda_step.kernel_params(p),
        wall_chassis=cuda_step.contact_params(ch_prm),
        wall_wheel=cuda_step.contact_params(w_prm), n_walls=len(p.walls))
    for i, (center, half) in enumerate(p.walls):
        kp.walls[i][:] = (*center, *half)
    return kp


# ------------------------------------------------------------ build / load

def _bind(path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    lib.k3_max_walls.argtypes = []
    lib.k3_max_walls.restype = ctypes.c_int
    if lib.k3_max_walls() != MAX_WALLS:
        raise RuntimeError(f"{path}: built for {lib.k3_max_walls()} walls, "
                           f"the wrapper for {MAX_WALLS}")
    P = ctypes.POINTER(_params_struct())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("k3_control_step_f32", "k3_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ptr] * 7 + [i32, P] + [i32] * 3 + [ptr]
            fn.restype = i32
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.k3_count_ops.argtypes = [dptr] * 7 + [P] + [i32] * 3
    lib.k3_count_ops.restype = ctypes.c_longlong
    return lib


def build(process=None):
    """Build K3 if its sources changed, load it, and return the library.
    `process` is a compile already started with `kernel_build.start_build`."""
    global _lib
    if _lib is None:
        _lib = _bind(kernel_build.build(LABEL, SOURCE, build_info, process))
    return _lib


# ------------------------------------------------------------ launch

def control_step_walls_cuda(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """Launch K3 on the current stream; CUDA tensors only."""
    global launches
    B = qpos.shape[0]
    cuda_step.check_kernel_args("K3", qpos, [
        ("qpos", qpos, (B, 9)), ("qvel", qvel, (B, 8)),
        ("ws", ws, (B, 8)), ("ctrl", ctrl, (B, 2))])
    kp = kernel_params(params)
    qp, qv, w = (torch.empty_like(t) for t in (qpos, qvel, ws))
    if B == 0:
        return qp, qv, w
    lib = build()
    fn = (lib.k3_control_step_f32 if qpos.dtype == torch.float32
          else lib.k3_control_step_f64)
    import ctypes
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qpos.data_ptr(), qvel.data_ptr(), ws.data_ptr(),
                 ctrl.data_ptr(), qp.data_ptr(), qv.data_ptr(), w.data_ptr(),
                 B, ctypes.byref(kp), params.newton_iters, params.ls_iters,
                 frame_skip, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    launches += 1
    return qp, qv, w


def count_ops(qpos, qvel, ws, ctrl, params, frame_skip=250, lib=None):
    """Run K3's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `_bind` (the source compiled as plain C++); by default the
    nvcc build."""
    import ctypes
    lib = lib or build()
    kp = kernel_params(params)
    dptr = ctypes.POINTER(ctypes.c_double)
    counts = []
    outs = [torch.empty(qpos.shape[0], n, dtype=torch.float64)
            for n in (9, 8, 8)]
    for i in range(qpos.shape[0]):
        ins = [t[i].detach().to("cpu", torch.float64).contiguous()
               for t in (qpos, qvel, ws, ctrl)]
        counts.append(lib.k3_count_ops(
            *(ctypes.cast(t.data_ptr(), dptr) for t in ins),
            *(ctypes.cast(o[i].data_ptr(), dptr) for o in outs),
            ctypes.byref(kp), params.newton_iters, params.ls_iters,
            frame_skip))
    return (counts, *outs)
