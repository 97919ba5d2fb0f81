"""ctypes bindings to the native C++ runtimes (`native/*.cc`).

Counterpart of `balance_robot_tpu/export/native_runtime.py`, over the same
sources:
  * `native/int8_runtime.cc`: runs `.brq` artifacts with the integer
    arithmetic of `ops/quant.py` (the TFLite-Micro stand-in);
  * `native/onnx_runtime.cc`: parses and runs the exported `.onnx` policy
    graph in float32 (the ONNX Runtime C++ stand-in, sb_rl.py:211-220).

Both are host code. At first use each is compiled by `g++` with the
Makefile's flags into `build/torch_native/` at the repository root; the
library's name carries a hash of its source and the flags, so an edited
source is rebuilt and an unchanged one reused. Nothing is written into
`native/`, which belongs to the JAX package's own build.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from . import onnx_runtime as pyrt

ROOT = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def build(src_name):
    """Compile `native/<src_name>` into lib<stem>_<hash>.so unless that
    exists; returns the library's path. Raises RuntimeError when g++
    fails."""
    src = NATIVE_DIR / src_name
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                       + src.read_bytes())
    so = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile beside the target and rename when done, so that a library
    # under its final name is always complete
    part = so.with_name(f".{so.stem}.{os.getpid()}.so")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(part), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src_name}:\n{res.stderr}")
    os.replace(part, so)
    return so


def _i8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeInt8Policy:
    """Runs a quantized 6-64-64-2 policy (`ops.quant.QuantizedMLP`) through
    the C++ integer kernels."""

    def __init__(self, qm):
        self.library = build("int8_runtime.cc")
        lib = ctypes.CDLL(str(self.library))
        lib.brq_create.restype = ctypes.c_void_p
        lib.brq_create.argtypes = [
            ctypes.POINTER(ctypes.c_int8)] * 3 + [
            ctypes.POINTER(ctypes.c_int32)] * 3 + [
            ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float]
        lib.brq_invoke.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int8),
                                   ctypes.POINTER(ctypes.c_int8)]
        lib.brq_run_float.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float)]
        lib.brq_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        # brq_create copies arrays of these fixed sizes
        w = [np.ascontiguousarray(a, np.int8) for a in qm.w]
        b = [np.ascontiguousarray(a, np.int32) for a in qm.b]
        shapes = [a.shape for a in w + b]
        if shapes != [(6, 64), (64, 64), (64, 2), (64,), (64,), (2,)]:
            raise ValueError(f"the int8 runtime runs a 6-64-64-2 policy, "
                             f"not one of shapes {shapes}")
        self._h = lib.brq_create(
            _i8(w[0]), _i8(w[1]), _i8(w[2]), _i32(b[0]), _i32(b[1]),
            _i32(b[2]), qm.in_q.scale, qm.in_q.zero_point,
            qm.out_q.scale, qm.out_q.zero_point,
            qm.w_scale[0], qm.w_scale[1], qm.w_scale[2],
            qm.act_q[0].scale, qm.act_q[1].scale)

    def invoke_int8(self, q_obs):
        """int8 obs (6,) -> int8 actions (2,)."""
        q_obs = np.ascontiguousarray(q_obs, np.int8)
        if q_obs.shape != (6,):
            raise ValueError(f"int8 obs of shape {q_obs.shape}, not (6,)")
        out = np.zeros(2, np.int8)
        self._lib.brq_invoke(self._h, _i8(q_obs), _i8(out))
        return out

    def run(self, obs):
        """float32 obs (6,) -> float32 actions (2,), quantized inside."""
        obs = np.ascontiguousarray(obs, np.float32)
        if obs.shape != (6,):
            raise ValueError(f"obs of shape {obs.shape}, not (6,)")
        out = np.zeros(2, np.float32)
        self._lib.brq_run_float(self._h, _f32(obs), _f32(out))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.brq_destroy(self._h)


class NativeOnnxSession:
    """InferenceSession work-alike over the C++ ONNX executor. Graph IO
    names come from the Python parser (`onnx_runtime.load_model`), which
    also checks the model; execution is native, one observation per run."""

    def __init__(self, path):
        model = pyrt.load_model(path)
        pyrt.check_model(model)
        g = model["graph"]
        init = set(g["initializers"])
        self._input_names = [n for n in g["inputs"] if n not in init]
        self._output_names = list(g["outputs"])

        self.library = build("onnx_runtime.cc")
        lib = ctypes.CDLL(str(self.library))
        lib.onnx_load.restype = ctypes.c_void_p
        lib.onnx_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.onnx_free.argtypes = [ctypes.c_void_p]
        lib.onnx_run.restype = ctypes.c_int
        lib.onnx_run.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.onnx_load(str(path).encode(), err, 256)
        if not self._h:
            raise ValueError(f"onnx_load: {err.value.decode()}")

    def get_inputs(self):
        return [pyrt._IoSpec(n) for n in self._input_names]

    def get_outputs(self):
        return [pyrt._IoSpec(n) for n in self._output_names]

    def run(self, output_names, feeds):
        obs = np.ascontiguousarray(
            list(feeds.values())[0], np.float32).reshape(-1)
        if output_names is None:
            output_names = self._output_names
        results = []
        err = ctypes.create_string_buffer(256)
        for name in output_names:
            idx = self._output_names.index(name)
            out = np.zeros(64, np.float32)
            n = self._lib.onnx_run(self._h, _f32(obs), obs.size, idx,
                                   _f32(out), out.size, err, 256)
            if n < 0:
                raise RuntimeError(f"onnx_run: {err.value.decode()}")
            results.append(out[:n].reshape(1, n))
        return results

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.onnx_free(self._h)
