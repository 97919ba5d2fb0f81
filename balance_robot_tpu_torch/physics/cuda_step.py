"""K1: the fused 250-substep control step, as a CUDA kernel for Hopper.

Replaces `balance_robot_tpu/physics/pallas_step.py::_kernel`. The kernel
source is `csrc/control_step.cu`; its plain PyTorch version is
`step.control_step`, wrapped here as `control_step_plain` with the
kernel's signature.

`control_step(qpos, qvel, ws, ctrl, friction, params)` launches the kernel
for CUDA tensors and runs the plain version for CPU tensors: the device of
the state decides, and a CUDA call that cannot build or launch raises. A
scene with walls goes to K3 (`cuda_move.py`) instead of K1.

The one source holds two instantiations of the kernel on the team solver,
and the batch size picks one, as for K3: below the crossover that the
`.cu` header names (serving, training at the CLI's 1,024 envs), a team of
32 lanes per env with its rows in shared memory; from it on (the 4096-env
collections), one thread per env with its rows in its own local array.
`KERNEL.launch_config(dtype, B)` reads the choice from the library
(`k1_launch_config`), and the launch passes it on; there is no other way
in.

`KERNEL` (`cuda_kernel.Kernel`) holds the library, its launch shapes and
crossovers, and the launch counts. The kernel is built at first use with
`nvcc` into `build/torch_kernels/` at the repository root, as a shared
library with a plain C interface loaded through `ctypes`
(`kernel_build.py`); a content hash of the source and of the headers it
includes names the library, so an edited source is rebuilt and an
unchanged one is reused.
"""

import ctypes

from . import cuda_kernel as ck
from .step import PhysState, control_step as _control_step_torch

LABEL, SOURCE = "k1", "control_step.cu"      # library label, file in csrc/


def _type_entries(lib):
    """Type K1's launch entries (an nvcc build's) and count entries."""
    P = ctypes.POINTER(ck.params_struct()[1])
    for name in ("k1_control_step_f32", "k1_control_step_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ck.PTR] * 8 + [ck.I32, P] + [ck.I32] * 5 \
                + [ck.PTR]
            fn.restype = ck.I32
    for name in ("k1_count_ops", "k1_count_ops_team_rows"):
        fn = getattr(lib, name)
        fn.argtypes = [ck.DPTR] * 4 + [ctypes.c_double] + [ck.DPTR] * 3 \
            + [P] + [ck.I32] * 4
        fn.restype = ctypes.c_longlong


KERNEL = ck.Kernel("K1", LABEL, SOURCE, ("k1_crossover",), _type_entries)


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
        # imported here, as the one edge between the kernels' wrappers
        from . import cuda_move
        return cuda_move.control_step_walls(qpos, qvel, ws, ctrl, params,
                                            frame_skip)
    if qpos.is_cuda:
        return control_step_cuda(qpos, qvel, ws, ctrl, friction, params,
                                 frame_skip)
    return control_step_plain(qpos, qvel, ws, ctrl, friction, params,
                              frame_skip)


def control_step_cuda(qpos, qvel, ws, ctrl, friction, params, frame_skip=250):
    """Launch K1 on the current stream, with the instantiation that
    `KERNEL.launch_config` names for the batch; CUDA tensors only."""
    if params.walls:
        raise ValueError("K1 has no wall contacts: a scene with walls runs "
                         "K3 (cuda_move)")
    B = qpos.shape[0]
    use_friction = friction is not None and params.dynamic_friction
    args = [("qpos", qpos, (B, 9)), ("qvel", qvel, (B, 8)),
            ("ws", ws, (B, 8)), ("ctrl", ctrl, (B, 2))]
    if use_friction:
        args.append(("friction", friction, (B,)))
    return KERNEL.launch(
        args, ck.kernel_params(params), params, frame_skip,
        mid=(friction.data_ptr() if use_friction else None,),
        tail=(int(use_friction),))


def count_ops(qpos, qvel, ws, ctrl, friction, params, frame_skip=250,
              lib=None, sections=None):
    """Run K1's own source on the host, in double, for one control step of
    each env given (CPU tensors). Returns (counts, qpos', qvel', ws'): the
    arithmetic operations per env and the new state. `lib` is a library
    bound with `KERNEL.bind` (the source compiled as plain C++); by default
    the nvcc build. A list `sections` receives each env's operations by
    section of the chain, its rows and coupled steps (`Kernel.count_ops`)."""
    kp = ck.kernel_params(params)
    use_friction = friction is not None and params.dynamic_friction

    def count_one(entry, i, ins, outs):
        fr = float(friction[i]) if use_friction else 0.0
        return entry(*ins, fr, *outs, ctypes.byref(kp), params.newton_iters,
                     params.ls_iters, frame_skip, int(use_friction))
    return KERNEL.count_ops((qpos, qvel, ws, ctrl), count_one, lib,
                            sections)
