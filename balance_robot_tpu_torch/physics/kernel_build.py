"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each kernel is one `.cu` source with a plain C interface. At first use it
is compiled by `nvcc` for sm_90a into `build/torch_kernels/` at the
repository root, as a shared library that `ctypes` loads. The library's
name carries a hash of the source, of every header of `csrc/` it includes
(directly or through another header) and of the compiler flags, so an edit
to a shared header rebuilds every kernel that includes it, and an unchanged
kernel is reused. `defines` (`-D` flags) and another source directory
(`csrc`) build a variant under its own name, for timing one design against
another in one run (`tools/time_kernels.py`). `cuda_kernel.Kernel` times
a kernel's build or load and its first launch as set-up spans
(`utils/profiling.setup_span`: `kernel.load`, `kernel.first_launch`).
"""

import contextlib
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

from ..utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_launched = set()   # the kernel entries launched in this process


def sources(name, csrc=None):
    """`csrc/<name>` and the `csrc/` headers it includes, transitively, in
    a fixed order."""
    seen, todo = [], [(csrc or CSRC) / name]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return [seen[0]] + sorted(seen[1:])


def source_tag(name, flags=NVCC_FLAGS, csrc=None):
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return str(nvcc)


def _library(label, name, csrc=None, defines=()):
    tag = source_tag(name, NVCC_FLAGS + tuple(defines), csrc)
    return (BUILD_DIR / f"lib{label}_{tag}.so",
            BUILD_DIR / f"lib{label}_{tag}.ptxas.txt")


def _partial(so):
    return so.with_name(f".{so.stem}.{os.getpid()}.so")


def start_build(label, name, csrc=None, defines=()):
    """Start nvcc on `csrc/<name>` unless its library is already built;
    returns the running process or None. `build` waits for it."""
    so, _ = _library(label, name, csrc, defines)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile beside the target and rename when done, so that a library
    # under its final name is always complete
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(_partial(so)),
         str((csrc or CSRC) / name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build(label, name, info, process=None, csrc=None, defines=()):
    """Build `csrc/<name>` into lib<label>_<hash>.so unless that exists, and
    return the library's path. `info` (a dict) receives the seconds taken,
    whether the library was reused, its path, ptxas's report and the
    `Used N registers` lines of it. `process` is a build that `start_build`
    already started with the same arguments."""
    so, log = _library(label, name, csrc, defines)
    t0 = time.perf_counter()
    cached = so.exists() and process is None
    if not cached:
        proc = process or start_build(label, name, csrc, defines)
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}:\n{err}")
            log.write_text(err)
            os.replace(_partial(so), so)
    ptxas = log.read_text() if log.exists() else ""
    info.update(seconds=time.perf_counter() - t0, cached=cached,
                library=str(so), ptxas=ptxas,
                resources=re.findall(r"Used \d+ registers[^\n]*", ptxas))
    return so


def first_launch(entry):
    """A `kernel.first_launch` set-up span around the process's first
    launch through the kernel entry `entry` (a name), else nothing: that
    host call holds CUDA's lazy load of the kernel."""
    if entry in _launched:
        return contextlib.nullcontext()
    _launched.add(entry)
    return profiling.setup_span("kernel.first_launch")
