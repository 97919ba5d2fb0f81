"""Self-contained ONNX runtime for the exported policy graph.

Counterpart of `balance_robot_tpu/export/onnx_runtime.py`, numpy only. The
reference validates its exported model with `onnx.checker` and runs it
with an onnxruntime InferenceSession (sb_rl.py:185-230); without either
package this module does the same:

  * a minimal protobuf wire-format parser for the ModelProto subset that
    `torch.onnx.export` (opset 11) emits, with no onnx/protobuf dependency;
  * `check_model`: structural validation standing in for onnx.checker
    (opset, graph topology, tensor payloads, supported ops);
  * `NumpySession`: an InferenceSession work-alike (get_inputs /
    get_outputs / run) evaluating the graph with numpy.

`session(path)` takes onnxruntime where it imports, else the native C++
executor (`native_runtime.NativeOnnxSession`), else the numpy executor,
in the JAX package's order. These are host runtimes: the deployment leg,
not the device path.
"""

import pathlib
import struct
import subprocess
import sys

import numpy as np


class OnnxValidationError(ValueError):
    pass


# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------

def _read_varint(buf, i):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise OnnxValidationError("malformed varint")


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer.
    value: int for varint/fixed, memoryview for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, i = _read_varint(buf, i)
        elif wtype == 1:
            val = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wtype == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:
            val = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise OnnxValidationError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_varints(buf):
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _signed(v):
    """protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# --------------------------------------------------------------------------
# ModelProto subset
# --------------------------------------------------------------------------

# TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           9: np.bool_, 11: np.float64}


def _parse_tensor(buf):
    dims, dtype, raw = [], None, None
    float_data, int_data, name = [], [], ""
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:                       # dims (int64, maybe packed)
            dims.extend(_signed(v) for v in
                        (_packed_varints(val) if wtype == 2 else [val]))
        elif fnum == 2:
            dtype = val
        elif fnum == 4:                     # float_data
            if wtype == 2:
                float_data.extend(np.frombuffer(bytes(val), "<f4"))
            else:
                float_data.append(struct.unpack("<f", struct.pack("<I",
                                                                  val))[0])
        elif fnum in (5, 7):                # int32_data / int64_data
            int_data.extend(_signed(v) for v in
                            (_packed_varints(val) if wtype == 2 else [val]))
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
    if dtype not in _DTYPES:
        raise OnnxValidationError(f"tensor {name!r}: unsupported dtype "
                                  f"{dtype}")
    np_dtype = _DTYPES[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np_dtype)
    elif int_data:
        arr = np.asarray(int_data, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    n_expect = int(np.prod(dims)) if dims else arr.size
    if arr.size != n_expect:
        raise OnnxValidationError(
            f"tensor {name!r}: payload has {arr.size} elements, dims "
            f"{dims} require {n_expect}")
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attribute(buf):
    name, value = "", None
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode()
        elif fnum == 2:                     # f (fixed32)
            value = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fnum == 3:                     # i
            value = _signed(val)
        elif fnum == 4:                     # s
            value = bytes(val)
        elif fnum == 5:                     # t
            value = _parse_tensor(val)[1]
        elif fnum == 7:                     # floats
            value = (list(np.frombuffer(bytes(val), "<f4"))
                     if wtype == 2 else [struct.unpack(
                         "<f", struct.pack("<I", val))[0]])
        elif fnum == 8:                     # ints
            cur = value if isinstance(value, list) else []
            cur.extend(_signed(v) for v in
                       (_packed_varints(val) if wtype == 2 else [val]))
            value = cur
    return name, value


def _parse_node(buf):
    node = {"input": [], "output": [], "op_type": "", "name": "",
            "attrs": {}}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node["input"].append(bytes(val).decode())
        elif fnum == 2:
            node["output"].append(bytes(val).decode())
        elif fnum == 3:
            node["name"] = bytes(val).decode()
        elif fnum == 4:
            node["op_type"] = bytes(val).decode()
        elif fnum == 5:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def _parse_value_info(buf):
    name = ""
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode()
    return name


def _parse_graph(buf):
    g = {"nodes": [], "initializers": {}, "inputs": [], "outputs": [],
         "name": ""}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            g["nodes"].append(_parse_node(val))
        elif fnum == 2:
            g["name"] = bytes(val).decode()
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g["initializers"][name] = arr
        elif fnum == 11:
            g["inputs"].append(_parse_value_info(val))
        elif fnum == 12:
            g["outputs"].append(_parse_value_info(val))
    return g


def load_model(path_or_bytes):
    """Parse an .onnx file into {ir_version, opsets, graph}."""
    if isinstance(path_or_bytes, (str, pathlib.Path)):
        data = pathlib.Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    model = {"ir_version": None, "opsets": {}, "graph": None}
    for fnum, _, val in _fields(memoryview(data)):
        if fnum == 1:
            model["ir_version"] = val
        elif fnum == 7:
            model["graph"] = _parse_graph(val)
        elif fnum == 8:                     # opset_import
            domain, version = "", 0
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    domain = bytes(v2).decode()
                elif f2 == 2:
                    version = v2
            model["opsets"][domain] = version
    if model["graph"] is None:
        raise OnnxValidationError("no graph in model (not an ONNX file?)")
    return model


# --------------------------------------------------------------------------
# checker (the onnx.checker stand-in)
# --------------------------------------------------------------------------

_SUPPORTED_OPS = {
    "Gemm", "MatMul", "Add", "Sub", "Mul", "Div", "Neg", "Exp",
    "Tanh", "Sigmoid", "Relu", "Identity", "Constant", "ConstantOfShape",
    "Shape", "Gather", "Unsqueeze", "Squeeze", "Concat", "Expand", "Cast",
    "Reshape", "Flatten", "Clip",
}

MAX_OPSET = 17


def check_model(model):
    """Structural validation: opset, topology, payloads, supported ops."""
    if model["ir_version"] is None:
        raise OnnxValidationError("missing ir_version")
    ai_onnx = model["opsets"].get("", model["opsets"].get("ai.onnx"))
    if ai_onnx is None:
        raise OnnxValidationError("missing ai.onnx opset import")
    if ai_onnx > MAX_OPSET:
        raise OnnxValidationError(f"opset {ai_onnx} > supported {MAX_OPSET}")
    g = model["graph"]
    if not g["outputs"]:
        raise OnnxValidationError("graph has no outputs")
    defined = set(g["initializers"]) | set(g["inputs"]) | {""}
    for node in g["nodes"]:
        if node["op_type"] not in _SUPPORTED_OPS:
            raise OnnxValidationError(
                f"unsupported op {node['op_type']!r} (node {node['name']!r})")
        for inp in node["input"]:
            if inp not in defined:
                raise OnnxValidationError(
                    f"node {node['name']!r} input {inp!r} is not produced "
                    "by any earlier node/initializer (graph not "
                    "topologically sorted or dangling reference)")
        defined.update(node["output"])
    for out in g["outputs"]:
        if out not in defined:
            raise OnnxValidationError(f"graph output {out!r} never produced")


# --------------------------------------------------------------------------
# numpy executor
# --------------------------------------------------------------------------

def _op_gemm(node, a, b, c=np.float32(0.0)):
    at = node["attrs"]
    if at.get("transA", 0):
        a = a.T
    if at.get("transB", 0):
        b = b.T
    return at.get("alpha", 1.0) * (a @ b) + at.get("beta", 1.0) * c


def _op_reshape(node, data, shape):
    shape = [int(s) for s in shape]
    shape = [data.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return data.reshape(shape)


def _op_unsqueeze(node, data, axes=None):
    # opset <= 12: axes attribute; opset >= 13: axes as a second input.
    if axes is None:
        if "axes" not in node["attrs"]:
            raise OnnxValidationError("Unsqueeze without axes (attr or input)")
        axes = node["attrs"]["axes"]
    axes = [int(a) for a in np.asarray(axes).reshape(-1)]
    rank = data.ndim + len(axes)          # negative axes are vs OUTPUT rank
    out = data
    for ax in sorted(a % rank for a in axes):
        out = np.expand_dims(out, ax)
    return out


def _op_squeeze(node, data, axes=None):
    # opset <= 12: axes attribute; opset >= 13: optional second input.
    if axes is None:
        axes = node["attrs"].get("axes")
    return (np.squeeze(data) if axes is None
            else np.squeeze(data, tuple(int(a) % data.ndim
                                        for a in np.asarray(axes).reshape(-1))))


def _op_constant(node):
    at = node["attrs"]
    if "value" in at:
        return at["value"]
    for k in ("value_float", "value_int"):
        if k in at:
            return np.asarray(at[k])
    for k in ("value_floats", "value_ints"):
        if k in at:
            return np.asarray(at[k])
    raise OnnxValidationError("Constant node without a value attribute")


def _op_flatten(node, data):
    ax = node["attrs"].get("axis", 1)
    lead = int(np.prod(data.shape[:ax])) if ax else 1
    return data.reshape(lead, -1)


def _op_clip(node, data, lo=None, hi=None):
    lo = node["attrs"].get("min", lo)
    hi = node["attrs"].get("max", hi)
    return np.clip(data, None if lo is None else np.asarray(lo),
                   None if hi is None else np.asarray(hi))


_OPS = {
    "Gemm": _op_gemm,
    "MatMul": lambda n, a, b: a @ b,
    "Add": lambda n, a, b: a + b,
    "Sub": lambda n, a, b: a - b,
    "Mul": lambda n, a, b: a * b,
    "Div": lambda n, a, b: a / b,
    "Neg": lambda n, a: -a,
    "Exp": lambda n, a: np.exp(a),
    "Tanh": lambda n, a: np.tanh(a),
    "Sigmoid": lambda n, a: 1.0 / (1.0 + np.exp(-a)),
    "Relu": lambda n, a: np.maximum(a, 0),
    "Identity": lambda n, a: a,
    "Constant": _op_constant,
    "ConstantOfShape": lambda n, s: np.full(
        [int(x) for x in s],
        n["attrs"].get("value", np.zeros(1, np.float32)).reshape(-1)[0]),
    "Shape": lambda n, a: np.asarray(a.shape, np.int64),
    "Gather": lambda n, a, idx: np.take(a, idx.astype(np.int64),
                                        axis=n["attrs"].get("axis", 0)),
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Concat": lambda n, *xs: np.concatenate(
        [np.atleast_1d(x) for x in xs], axis=n["attrs"].get("axis", 0)),
    "Expand": lambda n, a, shape: np.broadcast_to(
        a, np.broadcast_shapes(a.shape, tuple(int(s) for s in shape))),
    "Cast": lambda n, a: a.astype(_DTYPES[n["attrs"]["to"]]),
    "Reshape": _op_reshape,
    "Flatten": _op_flatten,
    "Clip": _op_clip,
}


class _IoSpec:
    def __init__(self, name):
        self.name = name


class NumpySession:
    """onnxruntime.InferenceSession work-alike on the numpy executor."""

    def __init__(self, path_or_bytes):
        self.model = load_model(path_or_bytes)
        check_model(self.model)
        self.graph = self.model["graph"]
        g = self.graph
        init = set(g["initializers"])
        self._inputs = [n for n in g["inputs"] if n not in init]

    def get_inputs(self):
        return [_IoSpec(n) for n in self._inputs]

    def get_outputs(self):
        return [_IoSpec(n) for n in self.graph["outputs"]]

    def run(self, output_names, feeds):
        g = self.graph
        values = dict(g["initializers"])
        for name, arr in feeds.items():
            if name not in self._inputs:
                raise OnnxValidationError(f"unknown graph input {name!r}")
            values[name] = np.asarray(arr)
        for node in g["nodes"]:
            args = [values[i] for i in node["input"] if i != ""]
            out = _OPS[node["op_type"]](node, *args)
            outs = out if isinstance(out, tuple) else (out,)
            for name, val in zip(node["output"], outs):
                values[name] = np.asarray(val)
        if output_names is None:
            output_names = g["outputs"]
        return [values[n] for n in output_names]


def session(path):
    """An inference session for `path`: onnxruntime when it imports, else
    the native C++ executor (`native/onnx_runtime.cc`, the ORT-C++
    stand-in, built into `build/torch_native/`), else the numpy executor
    with a notice on stderr. All legs share the get_inputs / get_outputs /
    run surface and validate the model first (onnx.checker /
    check_model)."""
    try:
        import onnx
        import onnxruntime as ort
        onnx.checker.check_model(onnx.load(str(path)))
        return ort.InferenceSession(str(path))
    except ImportError:
        pass
    try:
        from .native_runtime import NativeOnnxSession
        return NativeOnnxSession(path)
    except (OSError, RuntimeError, ValueError, ImportError,
            subprocess.SubprocessError) as e:
        # no toolchain or a failed build: the pure-python leg
        print(f"native ONNX runtime unavailable ({e}); using the numpy "
              "executor", file=sys.stderr)
        return NumpySession(path)
