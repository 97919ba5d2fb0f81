"""What the three kernel wrappers share: the ctypes mirror of the robot's
scene parameters, the check of a launch's tensors, and `Kernel`, one
kernel's library and launches.

A `Kernel` builds and loads its `.cu` source (`kernel_build.py`, the
`kernel.load` span), reads the launch shape that the library gives for a
batch (`launch_config`) and the batches at which the rung of teams changes
(`crossovers`), launches the instantiation of that rung on the current
stream (the `kernel.first_launch` span, the error check, `launches` and
`launches_by_team`), and runs the kernel's host build env by env
(`count_ops`). The wrappers (`cuda_step.py` K1, `cuda_block.py` K2,
`cuda_move.py` K3) state what is each kernel's own: its parameter struct,
the shapes of its arguments, its plain version and its entries' types.
"""

import ctypes
import functools

import torch

from . import kernel_build
from ..utils import profiling

I32, PTR = ctypes.c_int, ctypes.c_void_p
DPTR = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def params_struct():
    """The ctypes mirrors of the kernels' ContactP and Params structs."""

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
    """The kernels' ContactP struct for ContactParams `c`."""
    ContactP, _ = params_struct()
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
    """The kernels' Params struct (K1's own, the robot in K2's and K3's)
    for RobotSceneParams `p`, with every derived constant evaluated in
    double as the plain version does."""
    _, Params = params_struct()
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


class Kernel:
    """One kernel's library (`lib`, built and loaded at first use) and its
    launches since import, or since a caller set them back: `launches` in
    all and `launches_by_team` by the lanes per env that each took.

    `name` is the kernel's (K1), `label` its library's and entries' prefix
    (k1), `source` its file in `csrc/`, `crossovers` the names of the
    library's entries that give the batches at which its rung changes, and
    `type_entries(lib)` sets the argument types of its launch and count
    entries."""

    def __init__(self, name, label, source, crossovers, type_entries):
        self.name, self.label, self.source = name, label, source
        self.crossover_entries = crossovers
        self.type_entries = type_entries
        self.launches = 0
        self.launches_by_team = {}
        # filled by build(): seconds, whether the library was reused, ptxas
        self.build_info = {}
        self.lib = None

    def bind(self, path):
        """Load the library at `path` (an nvcc build, or the source compiled
        as plain C++ for the host, which has no launch entries) and type its
        entries."""
        lib = ctypes.CDLL(str(path))
        for name in self.crossover_entries:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I32
        config = getattr(lib, f"{self.label}_launch_config")
        config.argtypes = [I32, I32] + [ctypes.POINTER(I32)] * 3
        config.restype = None
        self.type_entries(lib)
        return lib

    def build(self, process=None):
        """Build the kernel if its sources changed, load it, and return the
        library. `process` is a compile already started with
        `kernel_build.start_build`."""
        if self.lib is None:
            with profiling.setup_span("kernel.load"):
                self.lib = self.bind(kernel_build.build(
                    self.label, self.source, self.build_info, process))
        return self.lib

    def crossovers(self, lib=None):
        """The batches, in order, from which a launch takes another rung's
        team (the `.cu` header's crossover macros)."""
        lib = lib or self.build()
        return sorted(getattr(lib, n)() for n in self.crossover_entries)

    def launch_config(self, dtype, B, lib=None):
        """(lanes per env, envs per block, shared bytes per block) of the
        instantiation that a launch of B envs of `dtype` (torch.float32 or
        torch.float64) takes. `lib`: a bound library (`bind`), by default
        the nvcc build."""
        vals = [I32() for _ in range(3)]
        getattr(lib or self.build(), f"{self.label}_launch_config")(
            int(dtype == torch.float64), B,
            *(ctypes.byref(v) for v in vals))
        return tuple(v.value for v in vals)

    def launch(self, args, kp, params, frame_skip, mid=(), tail=()):
        """Launch the kernel on the current stream with the instantiation
        that `launch_config` names for the batch, and return the new
        (qpos, qvel, ws). `args` is [(name, tensor, shape)] of every tensor
        the kernel takes, qpos, qvel, ws and ctrl first; `kp` the kernel's
        parameter struct. The entry takes the four, then `mid`, the three
        outputs, the batch, `kp`, the solver's iterations and `frame_skip`,
        then `tail`, the team and the stream."""
        qpos = args[0][1]
        check_kernel_args(self.name, qpos, args)
        outs = tuple(torch.empty_like(t) for _, t, _ in args[:3])
        B = qpos.shape[0]
        if B == 0:
            return outs
        lib = self.build()
        fn = getattr(lib, f"{self.label}_control_step_"
                     + ("f32" if qpos.dtype == torch.float32 else "f64"))
        team = self.launch_config(qpos.dtype, B, lib)[0]
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream().cuda_stream
            with kernel_build.first_launch(f"{fn.__name__}/{team}"):
                err = fn(*(t.data_ptr() for _, t, _ in args[:4]), *mid,
                         *(o.data_ptr() for o in outs), B, ctypes.byref(kp),
                         params.newton_iters, params.ls_iters, frame_skip,
                         *tail, team, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        self.launches_by_team[team] = self.launches_by_team.get(team, 0) + 1
        return outs

    def count_ops(self, states, count_one, lib=None):
        """Run the kernel's own source on the host, in double, for one
        control step of each env of `states` (qpos, qvel, ws, ctrl; CPU
        tensors). `count_one(entry, i, ins, outs)` calls the library's
        `<label>_count_ops` entry for env i with its four inputs and three
        outputs as double pointers, and returns the count. Returns (counts,
        qpos', qvel', ws'): the arithmetic operations per env and the new
        state. `lib`: as for `launch_config`."""
        entry = getattr(lib or self.build(), f"{self.label}_count_ops")
        B = states[0].shape[0]
        outs = [torch.empty(B, t.shape[1], dtype=torch.float64)
                for t in states[:3]]
        counts = []
        for i in range(B):
            ins = [t[i].detach().to("cpu", torch.float64).contiguous()
                   for t in states]
            counts.append(count_one(
                entry, i, [ctypes.cast(t.data_ptr(), DPTR) for t in ins],
                [ctypes.cast(o[i].data_ptr(), DPTR) for o in outs]))
        return (counts, *outs)
