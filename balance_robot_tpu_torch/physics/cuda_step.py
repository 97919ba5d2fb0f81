"""K1: the fused 250-substep control step, as a CUDA kernel for Hopper.

Replaces `balance_robot_tpu/physics/pallas_step.py::_kernel`. The kernel
source is `csrc/control_step.cu`; its plain PyTorch version is
`step.control_step`, wrapped here as `control_step_plain` with the
kernel's signature.

`control_step(qpos, qvel, ws, ctrl, friction, params)` launches the kernel
for CUDA tensors and runs the plain version for CPU tensors: the device of
the state decides, and a CUDA call that cannot build or launch raises. A
scene with walls goes to K3 (`cuda_move.py`) instead of K1.

The kernel is built at first use with `nvcc` into `build/torch_kernels/`
at the repository root, as a shared library with a plain C interface
loaded through `ctypes` (`kernel_build.py`); a content hash of the source
and of the headers it includes names the library, so an edited source is
rebuilt and an unchanged one is reused.
"""

import functools

import torch

from . import kernel_build
from .step import PhysState, control_step as _control_step_torch

LABEL, SOURCE = "k1", "control_step.cu"      # library label, file in csrc/

# kernel launches since import (or since a caller reset it to 0)
launches = 0
# filled by build(): seconds, whether the library was reused, ptxas report
build_info = {}
_lib = None


def control_step_plain(qpos, qvel, ws, ctrl, friction, params,
                       frame_skip=250):
    """The plain PyTorch version: K1's arithmetic one tensor op at a time."""
    s = _control_step_torch(PhysState(qpos, qvel, ws), ctrl, params,
                            friction=friction, frame_skip=frame_skip)
    return s.qpos, s.qvel, s.warmstart


def control_step(qpos, qvel, ws, ctrl, friction, params, frame_skip=250):
    """One control step of B envs: qpos (B,9), qvel (B,8), ws (B,8), ctrl
    (B,2), friction (B,) or None -> (qpos', qvel', ws').

    CUDA tensors launch K1 and CPU tensors take the plain version; a scene
    with walls goes to K3's wrapper, which decides likewise (it takes no
    friction)."""
    if params.walls:
        # imported here: cuda_move builds on this module
        from . import cuda_move
        return cuda_move.control_step_walls(qpos, qvel, ws, ctrl, params,
                                            frame_skip)
    if qpos.is_cuda:
        return control_step_cuda(qpos, qvel, ws, ctrl, friction, params,
                                 frame_skip)
    return control_step_plain(qpos, qvel, ws, ctrl, friction, params,
                              frame_skip)


# ------------------------------------------------------------ parameters

@functools.lru_cache(maxsize=None)
def _params_struct():
    """The ctypes mirrors of the kernel's ContactP and Params structs."""
    import ctypes

    class ContactP(ctypes.Structure):
        _fields_ = [(n, ctypes.c_double) for n in (
            "d0", "d1", "width", "mid", "power", "imp_a", "imp_b", "k", "b",
            "mu1", "mu2", "dA1", "dA2", "invweight")]

    class Params(ctypes.Structure):
        _fields_ = [(n, ctypes.c_double) for n in (
            "timestep", "gx", "gy", "gz", "m_ch", "m_w", "ich0", "ich1",
            "ich2", "iw0", "iw1", "iw2", "damping", "act_gain", "act_bias",
            "ctrl_range", "force_range")] + [("wheel", ContactP),
                                             ("chassis", ContactP)]
    return ContactP, Params


def contact_params(c):
    """The kernel's ContactP struct for ContactParams `c`."""
    ContactP, _ = _params_struct()
    d0, d1, width, mid, power = c.solimp
    tc, dr = c.solref
    dmax = max(d0, d1)
    mu1, mu2 = c.friction
    return ContactP(
        d0=d0, d1=d1, width=width, mid=mid, power=power,
        imp_a=1.0 / (mid ** (power - 1.0)),
        imp_b=1.0 / ((1.0 - mid) ** (power - 1.0)),
        k=1.0 / (dmax * dmax * tc * tc * dr * dr), b=2.0 / (dmax * tc),
        mu1=mu1, mu2=mu2,
        dA1=2.0 * mu1 * mu1 * (1.0 + mu1 * mu1) * c.invweight,
        dA2=2.0 * mu2 * mu2 * (1.0 + mu2 * mu2) * c.invweight,
        invweight=c.invweight)


def kernel_params(p):
    """The kernel's Params struct for RobotSceneParams `p`, with every
    derived constant evaluated in double as the plain version does."""
    _, Params = _params_struct()
    # fk reads the masses and inertias of ENV01_PARAMS, shared by all scenes
    from .robot_core import ENV01_PARAMS as m
    return Params(
        timestep=p.timestep, gx=p.gravity[0], gy=p.gravity[1],
        gz=p.gravity[2], m_ch=m.m_chassis, m_w=m.m_wheel,
        ich0=m.i_chassis[0], ich1=m.i_chassis[1], ich2=m.i_chassis[2],
        iw0=m.i_wheel[0], iw1=m.i_wheel[1], iw2=m.i_wheel[2],
        damping=p.joint_damping, act_gain=p.act_gain, act_bias=p.act_bias,
        ctrl_range=p.ctrl_range, force_range=p.force_range,
        wheel=contact_params(p.wheel_contact),
        chassis=contact_params(p.chassis_contact))


# ------------------------------------------------------------ build / load

def _bind(path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    _, Params = _params_struct()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("k1_control_step_f32", "k1_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ptr] * 8 + [i32, ctypes.POINTER(Params)] \
                + [i32] * 4 + [ptr]
            fn.restype = i32
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.k1_count_ops.argtypes = [dptr] * 4 + [ctypes.c_double] + [dptr] * 3 \
        + [ctypes.POINTER(Params)] + [i32] * 4
    lib.k1_count_ops.restype = ctypes.c_longlong
    return lib


def build(process=None):
    """Build K1 if its sources changed, load it, and return the library.
    `process` is a compile already started with `kernel_build.start_build`."""
    global _lib
    if _lib is None:
        _lib = _bind(kernel_build.build(LABEL, SOURCE, build_info, process))
    return _lib


# ------------------------------------------------------------ launch

def check_kernel_args(kernel, ref, args):
    """Raise unless every (name, tensor, shape) of `args` is a contiguous
    float32 / float64 CUDA tensor of that shape, on `ref`'s device and of
    its dtype: what the kernels take."""
    for name, t, shape in args:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{kernel}: {name} must be on {ref.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype != ref.dtype or t.dtype not in (torch.float32,
                                                   torch.float64):
            raise ValueError(f"{kernel}: {name} must be float32 or float64 "
                             f"like qpos, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def control_step_cuda(qpos, qvel, ws, ctrl, friction, params, frame_skip=250):
    """Launch K1 on the current stream; CUDA tensors only."""
    global launches
    if params.walls:
        raise ValueError("K1 has no wall contacts: a scene with walls runs "
                         "K3 (cuda_move)")
    B = qpos.shape[0]
    use_friction = friction is not None and params.dynamic_friction
    args = [("qpos", qpos, (B, 9)), ("qvel", qvel, (B, 8)),
            ("ws", ws, (B, 8)), ("ctrl", ctrl, (B, 2))]
    if use_friction:
        args.append(("friction", friction, (B,)))
    check_kernel_args("K1", qpos, args)
    qp, qv, w = (torch.empty_like(t) for t in (qpos, qvel, ws))
    if B == 0:
        return qp, qv, w
    lib = build()
    fn = (lib.k1_control_step_f32 if qpos.dtype == torch.float32
          else lib.k1_control_step_f64)
    import ctypes
    fric_ptr = friction.data_ptr() if use_friction else None
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qpos.data_ptr(), qvel.data_ptr(), ws.data_ptr(),
                 ctrl.data_ptr(), fric_ptr,
                 qp.data_ptr(), qv.data_ptr(), w.data_ptr(), B,
                 ctypes.byref(kernel_params(params)), params.newton_iters,
                 params.ls_iters, frame_skip, int(use_friction), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    launches += 1
    return qp, qv, w


def count_ops(qpos, qvel, ws, ctrl, friction, params, frame_skip=250,
              lib=None):
    """Run K1's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `_bind` (the source compiled as plain C++); by default the
    nvcc build."""
    import ctypes
    lib = lib or build()
    kp = kernel_params(params)
    use_friction = friction is not None and params.dynamic_friction
    dptr = ctypes.POINTER(ctypes.c_double)
    counts = []
    outs = [torch.empty(qpos.shape[0], n, dtype=torch.float64)
            for n in (9, 8, 8)]
    for i in range(qpos.shape[0]):
        ins = [t[i].detach().to("cpu", torch.float64).contiguous()
               for t in (qpos, qvel, ws, ctrl)]
        fr = float(friction[i]) if use_friction else 0.0
        counts.append(lib.k1_count_ops(
            *(ctypes.cast(t.data_ptr(), dptr) for t in ins), fr,
            *(ctypes.cast(o[i].data_ptr(), dptr) for o in outs),
            ctypes.byref(kp), params.newton_iters, params.ls_iters,
            frame_skip, int(use_friction)))
    return (counts, *outs)
