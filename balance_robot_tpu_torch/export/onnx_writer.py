"""ONNX (opset 11) serializer for the policy graph, in numpy and `struct`.

Counterpart of `balance_robot_tpu/export/onnx_writer.py`: the same
ModelProto bytes for the same weights, so a checkpoint exported by either
package gives the same `.onnx` file. The artifact contract is the
reference's (`sb_rl.py:126-133`): opset 11, input 'input' [1, obs_dim],
first output 'output' = the actions tensor, plus 'value' and 'log_std'
for the PPO/A2C policy triple.

One difference: `build_actor_onnx` takes `act_dim` from its caller and
reads an off-policy head by it, `act_dim` wide (TD3/DDPG) or `2 * act_dim`
wide (SAC's [mean, log_std]), where the JAX package assumes 2 actions.

Wire-format encoding follows the protobuf spec; field numbers are from
onnx.proto3 (ModelProto / GraphProto / NodeProto / TensorProto /
ValueInfoProto). `onnx_runtime.py` parses and runs what this writes.
"""

import numpy as np

# --------------------------------------------------------------- encoding

def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _ld(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def _string(field, s):
    return _ld(field, s.encode())


def _int(field, v):
    return _tag(field, 0) + _varint(v)


# ------------------------------------------------------------- onnx protos

def _tensor(name, arr):
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out = b"".join(_int(1, d) for d in arr.shape)
    out += _int(2, 1)                       # FLOAT
    out += _string(8, name)
    out += _ld(9, arr.tobytes())
    return out


def _value_info(name, shape):
    """ValueInfoProto: name=1, type=2 -> TypeProto.tensor_type=1 ->
    (elem_type=1, shape=2 -> dim=1 -> dim_value=1)."""
    dims = b"".join(_ld(1, _int(1, d)) for d in shape)
    tensor_type = _int(1, 1) + _ld(2, dims)
    return _string(1, name) + _ld(2, _ld(1, tensor_type))


def _node(op_type, inputs, outputs, name):
    """NodeProto: input=1, output=2, name=3, op_type=4 (no attributes:
    Gemm's defaults alpha=beta=1, transA=transB=0 are what is emitted)."""
    out = b"".join(_string(1, i) for i in inputs)
    out += b"".join(_string(2, o) for o in outputs)
    out += _string(3, name)
    out += _string(4, op_type)
    return out


def _model(graph):
    """ModelProto: ir_version=1 (6 <-> opset 11), producer_name=2, graph=7,
    opset_import=8. The producer name is the JAX package's, so that both
    packages write the same bytes."""
    opset = _string(1, "") + _int(2, 11)
    return (_int(1, 6) + _string(2, "balance_robot_tpu") + _ld(7, graph)
            + _ld(8, opset))


def build_policy_onnx(params):
    """Serialize the (actions, value, log_std) policy graph to ONNX bytes;
    the widths are read from the arrays."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}

    inits = [
        _tensor("pi_w1", p["pi_w1"]), _tensor("pi_b1", p["pi_b1"]),
        _tensor("pi_w2", p["pi_w2"]), _tensor("pi_b2", p["pi_b2"]),
        _tensor("pi_wout", p["pi_wout"]), _tensor("pi_bout", p["pi_bout"]),
        _tensor("vf_w1", p["vf_w1"]), _tensor("vf_b1", p["vf_b1"]),
        _tensor("vf_w2", p["vf_w2"]), _tensor("vf_b2", p["vf_b2"]),
        _tensor("vf_wout", p["vf_wout"]), _tensor("vf_bout", p["vf_bout"]),
        _tensor("log_std_c", p["log_std"].reshape(1, -1)),
    ]
    nodes = [
        _node("Gemm", ["input", "pi_w1", "pi_b1"], ["p_h1"], "pi_fc1"),
        _node("Tanh", ["p_h1"], ["p_a1"], "pi_tanh1"),
        _node("Gemm", ["p_a1", "pi_w2", "pi_b2"], ["p_h2"], "pi_fc2"),
        _node("Tanh", ["p_h2"], ["p_a2"], "pi_tanh2"),
        _node("Gemm", ["p_a2", "pi_wout", "pi_bout"], ["output"], "pi_out"),
        _node("Gemm", ["input", "vf_w1", "vf_b1"], ["v_h1"], "vf_fc1"),
        _node("Tanh", ["v_h1"], ["v_a1"], "vf_tanh1"),
        _node("Gemm", ["v_a1", "vf_w2", "vf_b2"], ["v_h2"], "vf_fc2"),
        _node("Tanh", ["v_h2"], ["v_a2"], "vf_tanh2"),
        _node("Gemm", ["v_a2", "vf_wout", "vf_bout"], ["value"], "vf_out"),
        _node("Identity", ["log_std_c"], ["log_std"], "log_std_id"),
    ]
    obs_dim = p["pi_w1"].shape[0]
    act_dim = p["pi_wout"].shape[1]

    # GraphProto: node=1, name=2, initializer=5, input=11, output=12
    graph = b"".join(_ld(1, n) for n in nodes)
    graph += _string(2, "balance_robot_policy")
    graph += b"".join(_ld(5, t) for t in inits)
    graph += _ld(11, _value_info("input", (1, obs_dim)))
    graph += _ld(12, _value_info("output", (1, act_dim)))
    graph += _ld(12, _value_info("value", (1, 1)))
    graph += _ld(12, _value_info("log_std", (1, act_dim)))
    return _model(graph)


def actor_head(width, act_dim):
    """How an off-policy actor's head of `width` outputs deploys for
    `act_dim` actions: "sac" for SAC's [mean, log_std] (2 * act_dim wide;
    the action is tanh(mean)), "direct" for TD3/DDPG (act_dim wide, squashed
    as it is). Raises ValueError for any other width."""
    if width == act_dim:
        return "direct"
    if width == 2 * act_dim:
        return "sac"
    raise ValueError(f"actor head of width {width} fits neither TD3/DDPG "
                     f"({act_dim}) nor SAC ({2 * act_dim}) at act_dim "
                     f"{act_dim}")


def build_actor_onnx(W, B, act_dim):
    """The deterministic off-policy actor: a ReLU MLP with a tanh-squashed
    head (see `actor_head`). SAC's mean is taken with a constant selection
    Gemm, so the graph stays Gemm/Relu/Tanh and holds no Exp (the op that
    blocks the reference's SAC int8 TFLite conversion, reference
    README.md:177-180)."""
    W = [np.asarray(w, np.float32) for w in W]
    B = [np.asarray(b, np.float32) for b in B]
    sac = actor_head(W[-1].shape[1], act_dim) == "sac"
    inits, nodes = [], []
    name_in = "input"
    for i, (w, b) in enumerate(zip(W, B)):
        inits += [_tensor(f"a_w{i}", w), _tensor(f"a_b{i}", b)]
        nodes.append(_node("Gemm", [name_in, f"a_w{i}", f"a_b{i}"],
                           [f"a_h{i}"], f"actor_fc{i}"))
        if i < len(W) - 1:
            nodes.append(_node("Relu", [f"a_h{i}"], [f"a_r{i}"],
                               f"actor_relu{i}"))
            name_in = f"a_r{i}"
    head = f"a_h{len(W) - 1}"
    if sac:
        sel = np.zeros((2 * act_dim, act_dim), np.float32)
        sel[:act_dim, :act_dim] = np.eye(act_dim)
        inits += [_tensor("a_sel", sel),
                  _tensor("a_sel_b", np.zeros(act_dim, np.float32))]
        nodes.append(_node("Gemm", [head, "a_sel", "a_sel_b"], ["a_mean"],
                           "actor_mean"))
        head = "a_mean"
    nodes.append(_node("Tanh", [head], ["output"], "actor_tanh"))

    graph = b"".join(_ld(1, n) for n in nodes)
    graph += _string(2, "balance_robot_actor")
    graph += b"".join(_ld(5, t) for t in inits)
    graph += _ld(11, _value_info("input", (1, W[0].shape[0])))
    graph += _ld(12, _value_info("output", (1, act_dim)))
    return _model(graph)
