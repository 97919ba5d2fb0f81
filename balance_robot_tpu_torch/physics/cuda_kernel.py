"""What the three kernel wrappers share: the ctypes mirror of the robot's
scene parameters, the check of a launch's tensors, and `Kernel`, one
kernel's library and launches.

A `Kernel` builds and loads its `.cu` source and every instantiation in it
(`kernel_build.py`, the `kernel.load` span), reads the launch shape that
the library gives for a batch (`launch_config`) and the batches at which
the rung of teams changes (`crossovers`), launches the instantiation of
that rung on the current stream (the `kernel.first_launch` span, the error
check, `launches` and `launches_by_team`), and runs the kernel's host
build env by env (`count_ops`). The wrappers (`cuda_step.py` K1,
`cuda_block.py` K2, `cuda_move.py` K3) state what is each kernel's own:
its parameter struct, the shapes of its arguments, its plain version and
its entries' types.

Section counters (`csrc/robot_common.cuh`): while a `torch.profiler`
session records, a launch takes the rung's timed instantiation, which adds
each env's SM cycles in each section of the chain (SECTIONS), its rows,
its coupled Newton steps and the launch to the env's row of an int64
(B, len(COUNTERS)) buffer on the card, one per batch size; otherwise the
untimed one, which leaves them alone. `sections()` reads the buffers,
`clear_sections()` zeroes them, and `utils/profiling.counters()` folds
them into the store as `<label>.cycles.<section>` and the rest
(`folded`). The host build counts operations by the same sections
(`count_ops(..., sections=)`).
"""

import ctypes
import functools

import torch

from . import kernel_build
from ..utils import profiling

I32, PTR = ctypes.c_int, ctypes.c_void_p
DPTR = ctypes.POINTER(ctypes.c_double)
LLPTR = ctypes.POINTER(ctypes.c_longlong)

# an env's counters, in robot_common.cuh's order: the sections of the chain,
# then the rows, the coupled Newton steps and the launches
SECTIONS = ("smooth", "contacts", "hessian", "factor", "linesearch",
            "update")
COUNTERS = SECTIONS + ("rows", "coupled", "launches")


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
        self._counters = {}    # (device, B): the timed launches' counters
        profiling.fold(self.folded, self.clear_sections)

    def bind(self, path):
        """Load the library at `path` (an nvcc build, or the source compiled
        as plain C++ for the host, which has no launch entries) and type its
        entries: the wrapper's (`type_entries`), then each timed launch entry
        and each `_sections` count entry as its plain one with the counters'
        pointer (before the team and the stream; last)."""
        lib = ctypes.CDLL(str(path))
        for name in self.crossover_entries:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I32
        config = getattr(lib, f"{self.label}_launch_config")
        config.argtypes = [I32, I32] + [ctypes.POINTER(I32)] * 3
        config.restype = None
        self.type_entries(lib)
        for dt in ("f32", "f64"):
            timed = getattr(lib, f"{self.label}_control_step_timed_{dt}",
                            None)
            if timed is not None:
                args = getattr(lib, f"{self.label}_control_step_{dt}"
                               ).argtypes
                timed.argtypes = args[:-2] + [PTR] + args[-2:]
                timed.restype = I32
        per_sm = getattr(lib, f"{self.label}_blocks_per_sm", None)
        if per_sm is not None:
            per_sm.argtypes = [I32, I32]
            per_sm.restype = I32
        count = getattr(lib, f"{self.label}_count_ops_sections", None)
        if count is not None:
            count.argtypes = getattr(lib, f"{self.label}_count_ops"
                                     ).argtypes + [LLPTR]
            count.restype = ctypes.c_longlong
        return lib

    def build(self, process=None):
        """Build the kernel if its sources changed, load it and every
        instantiation in it (so that no launch, timed or not, pays CUDA's
        lazy load of its kernel), and return the library. `process` is a
        compile already started with `kernel_build.start_build`."""
        if self.lib is None:
            with profiling.setup_span("kernel.load"):
                lib = self.bind(kernel_build.build(
                    self.label, self.source, self.build_info, process))
                load = getattr(lib, f"{self.label}_load", None)
                err = load() if load is not None else 0
                if err != 0:
                    raise RuntimeError(f"{self.name} failed to load: CUDA "
                                       f"error {err}")
                self.lib = lib
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

    def waves(self, dtype, B, lib=None):
        """The waves that a launch of B envs of `dtype` takes on the current
        device: its blocks over the blocks that all its SMs hold at once
        (the library's `<label>_blocks_per_sm`, an occupancy query)."""
        lib = lib or self.build()
        team, envs, _ = self.launch_config(dtype, B, lib)
        per_sm = getattr(lib, f"{self.label}_blocks_per_sm")(
            int(dtype == torch.float64), team)
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        return -(-(-(-B // envs)) // (per_sm * sms))

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
        # the timed instantiation only while a profiler records (as
        # profiling.span), with the counters of this batch size (a normal
        # tensor even under inference mode, so that clear_sections may zero
        # it outside)
        counters = ()
        if profiling.recording():
            key = (qpos.device, B)
            if key not in self._counters:
                with torch.inference_mode(False):
                    self._counters[key] = torch.zeros(
                        (B, len(COUNTERS)), dtype=torch.int64,
                        device=qpos.device)
            counters = (self._counters[key].data_ptr(),)
        fn = getattr(lib, f"{self.label}_control_step_"
                     + ("timed_" if counters else "")
                     + ("f32" if qpos.dtype == torch.float32 else "f64"))
        team = self.launch_config(qpos.dtype, B, lib)[0]
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream().cuda_stream
            with kernel_build.first_launch(f"{fn.__name__}/{team}"):
                err = fn(*(t.data_ptr() for _, t, _ in args[:4]), *mid,
                         *(o.data_ptr() for o in outs), B, ctypes.byref(kp),
                         params.newton_iters, params.ls_iters, frame_skip,
                         *tail, *counters, team, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        self.launches_by_team[team] = self.launches_by_team.get(team, 0) + 1
        return outs

    def count_ops(self, states, count_one, lib=None, sections=None):
        """Run the kernel's own source on the host, in double, for one
        control step of each env of `states` (qpos, qvel, ws, ctrl; CPU
        tensors). `count_one(entry, i, ins, outs)` calls the library's
        `<label>_count_ops` entry for env i with its four inputs and three
        outputs as double pointers, and returns the count. Returns (counts,
        qpos', qvel', ws'): the arithmetic operations per env and the new
        state. `lib`: as for `launch_config`. A list `sections` receives,
        per env, {counter: n} of COUNTERS but the launches: the operations
        of each section of the chain, the rows and the coupled Newton steps
        (the `<label>_count_ops_sections` entry)."""
        lib = lib or self.build()
        row = (ctypes.c_longlong * (len(COUNTERS) - 1))()
        if sections is None:
            entry = getattr(lib, f"{self.label}_count_ops")
        else:
            with_row = getattr(lib, f"{self.label}_count_ops_sections")

            def entry(*args):
                return with_row(*args, row)
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
            if sections is not None:
                sections.append(dict(zip(COUNTERS, row)))
        return (counts, *outs)

    # ------------------------------------------------------ section counters

    def section_rows(self):
        """{B: the (B, len(COUNTERS)) int64 counters of the timed launches
        of B envs, on the host}, summed over devices; one copy from the
        card for all of them."""
        if not self._counters:
            return {}
        keys = list(self._counters)
        first = self._counters[keys[0]].device
        flat = torch.cat([self._counters[k].to(first) for k in keys]).cpu()
        out = {}
        for (_, B), part in zip(keys, flat.split([k[1] for k in keys])):
            out[B] = out[B] + part if B in out else part
        return out

    def sections(self):
        """The timed launches' counters: {"total": {counter: n} summed over
        envs and launches, "slowest_env": {counter: n} of the env whose
        sections summed most cycles, "envs": the envs counted,
        "launches": the timed launches}; None before any timed launch."""
        by_batch = self.section_rows()
        if not by_batch:
            return None
        rows = torch.cat(list(by_batch.values()))
        rows = rows[rows[:, COUNTERS.index("launches")] > 0]
        if rows.shape[0] == 0:
            return None
        slowest = rows[:, :len(SECTIONS)].sum(1).argmax()
        launches = sum(int(r[:, COUNTERS.index("launches")].max())
                       for r in by_batch.values())
        return dict(total=dict(zip(COUNTERS, rows.sum(0).tolist())),
                    slowest_env=dict(zip(COUNTERS, rows[slowest].tolist())),
                    envs=rows.shape[0], launches=launches)

    def clear_sections(self):
        """Zero the counters of every batch size."""
        for t in self._counters.values():
            t.zero_()

    def folded(self):
        """The counters as `profiling.counters()` folds them: per section
        `<label>.cycles.<section>`, the slowest env's summed cycles
        (`.cycles.slowest_env`), `.envs`, `.rows`, `.coupled_steps` and
        `.timed_launches`; {} before any timed launch."""
        found = self.sections()
        if found is None:
            return {}
        total, label = found["total"], self.label
        out = {f"{label}.cycles.{s}": total[s] for s in SECTIONS}
        out.update({
            f"{label}.cycles.slowest_env": sum(found["slowest_env"][s]
                                               for s in SECTIONS),
            f"{label}.envs": found["envs"], f"{label}.rows": total["rows"],
            f"{label}.coupled_steps": total["coupled"],
            f"{label}.timed_launches": found["launches"]})
        return out
