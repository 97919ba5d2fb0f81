"""Policy export pipeline: params -> ONNX / TF SavedModel -> int8 TFLite ->
model.h, and the `.brq` int8 artifact.

Counterpart of `balance_robot_tpu/export/pipeline.py`, on the params dict
of numpy arrays that `train.checkpoint.load` returns (the same npz layout
in both packages):

  * `export_onnx`: the policy graph written by `onnx_writer`, opset 11,
    input 'input', first output 'output' = actions; byte-identical to the
    JAX package's file for the same checkpoint;
  * `export_savedmodel`: the same network as a tf.Module returning the
    (value, actions, log_std) triple (sb_rl.py:319-321), or an off-policy
    checkpoint's deterministic actor;
  * `quantize_tflite`: TFLiteConverter with Optimize.DEFAULT, int8 in and
    out, on the reference's 3-row representative set
    (quantize_tflite.py:9-33);
  * `write_model_h`: the `xxd -i` equivalent for TFLite-Micro (README.md:120);
  * `export_brq` / `save_brq` / `load_brq`: the compact int8 artifact of
    `ops/quant.py`, in the JAX package's npz key layout, so either package
    loads what the other wrote.

Every exporter that reads an off-policy head takes `act_dim` (the env's
action width) and classifies the head by it (`onnx_writer.actor_head`),
where the JAX package assumes 2 actions. TensorFlow is imported only by
`export_savedmodel` and `quantize_tflite`, which raise ImportError where it
is not installed, as in the JAX package.
"""

import pathlib

import numpy as np

from ..models.mlp import deployable_params
from ..ops import quant
from ..ops.quant import QuantizedMLP, QuantTensor
from .onnx_writer import actor_head, build_actor_onnx, build_policy_onnx

# the reference's representative dataset (quantize_tflite.py:9-13)
REPRESENTATIVE = quant.REPRESENTATIVE_OBS


def offpolicy_actor(params):
    """(W, B) layer lists of the deterministic actor if `params` is an
    off-policy checkpoint (nested `actor/<i>/{w,b}` keys, as
    `checkpoint.save` flattens the off-policy nets); None for PPO/A2C
    params."""
    if "actor/0/w" not in params:
        return None
    W, B, i = [], [], 0
    while f"actor/{i}/w" in params:
        W.append(np.asarray(params[f"actor/{i}/w"], np.float32))
        B.append(np.asarray(params[f"actor/{i}/b"], np.float32))
        i += 1
    return W, B


def _policy_act_dim(params, act_dim):
    width = np.shape(params["pi_wout"])[1]
    if width != act_dim:
        raise ValueError(f"policy head of width {width} at act_dim "
                         f"{act_dim}")


def export_onnx(params, path, act_dim):
    """Write the policy's ONNX graph to `path` (reference `convert`: opset
    11, input 'input', first output 'output' = actions, sb_rl.py:126-133).

    Off-policy checkpoints (SAC/TD3/DDPG) export the deterministic actor
    only (Gemm/Relu/Tanh). A privileged critic is sliced back to the
    actor's obs width first (`mlp.deployable_params`)."""
    actor = offpolicy_actor(params)
    if actor is not None:
        blob = build_actor_onnx(*actor, act_dim)
    else:
        _policy_act_dim(params, act_dim)
        blob = build_policy_onnx(deployable_params(params))
    pathlib.Path(path).write_bytes(blob)
    return path


def export_savedmodel(params, path, act_dim):
    """TF SavedModel of the (value, actions, log_std) graph; off-policy
    checkpoints export the deterministic actor ({'actions'} only: the
    relu/tanh graph has no Exp, so int8 TFLite conversion succeeds where
    the reference's SAC export does not, reference README.md:177-180)."""
    import tensorflow as tf

    actor = offpolicy_actor(params)
    if actor is not None:
        W, B = [[tf.constant(a) for a in t] for t in actor]
        obs_dim = int(actor[0][0].shape[0])
        sac = actor_head(actor[0][-1].shape[1], act_dim) == "sac"

        class Actor(tf.Module):
            @tf.function(input_signature=[
                tf.TensorSpec([1, obs_dim], tf.float32, name="input")])
            def __call__(self, x):
                for w, b in zip(W[:-1], B[:-1]):
                    x = tf.nn.relu(x @ w + b)
                x = x @ W[-1] + B[-1]
                if sac:
                    x = x[:, :act_dim]
                return {"actions": tf.tanh(x)}

        tf.saved_model.save(Actor(), str(path))
        return path

    _policy_act_dim(params, act_dim)
    w = {k: np.asarray(v) for k, v in deployable_params(params).items()}
    obs_dim = w["pi_w1"].shape[0]

    class Policy(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, obs_dim], tf.float32, name="input")])
        def __call__(self, x):
            a = tf.tanh(x @ w["pi_w1"] + w["pi_b1"])
            a = tf.tanh(a @ w["pi_w2"] + w["pi_b2"])
            actions = a @ w["pi_wout"] + w["pi_bout"]
            v = tf.tanh(x @ w["vf_w1"] + w["vf_b1"])
            v = tf.tanh(v @ w["vf_w2"] + w["vf_b2"])
            value = v @ w["vf_wout"] + w["vf_bout"]
            log_std = tf.broadcast_to(
                tf.constant(w["log_std"], tf.float32),
                (tf.shape(x)[0], act_dim))
            return {"value": value, "actions": actions, "log_std": log_std}

    tf.saved_model.save(Policy(), str(path))
    return path


def quantize_tflite(saved_model_dir, out_path, float32=False):
    """SavedModel -> (int8 by default) .tflite, reference representative
    set."""
    import tensorflow as tf

    conv = tf.lite.TFLiteConverter.from_saved_model(str(saved_model_dir))
    if not float32:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]

        def rep():
            for row in REPRESENTATIVE:
                yield {"input": row[None, :]}

        conv.representative_dataset = rep
        conv.target_spec.supported_ops = [
            tf.lite.OpsSet.TFLITE_BUILTINS_INT8,
            tf.lite.OpsSet.TFLITE_BUILTINS,
        ]
        conv.inference_input_type = tf.int8
        conv.inference_output_type = tf.int8
    blob = conv.convert()
    pathlib.Path(out_path).write_bytes(blob)
    return out_path


def write_model_h(tflite_path, out_path, var_name="model"):
    """xxd -i equivalent: C array for TFLite-Micro embedding."""
    data = pathlib.Path(tflite_path).read_bytes()
    lines = [f"unsigned char {var_name}[] = {{"]
    for i in range(0, len(data), 12):
        chunk = ", ".join(f"0x{b:02x}" for b in data[i:i + 12])
        lines.append(f"  {chunk},")
    lines[-1] = lines[-1].rstrip(",")
    lines.append("};")
    lines.append(f"unsigned int {var_name}_len = {len(data)};")
    pathlib.Path(out_path).write_text("\n".join(lines) + "\n")
    return out_path


def export_brq(params, path):
    """The int8 artifact of a PPO/A2C policy (`quant.quantize_policy`)."""
    if offpolicy_actor(params) is not None:
        # the .brq semantics (ops/quant.py, native/int8_runtime.cc) are
        # those of the deployed tanh-MLP policy: the relu actor's final
        # tanh squash would need an int8 tanh table in both runtimes. The
        # int8 deployment of SAC/TD3/DDPG is the TFLite leg (`quantize`).
        raise NotImplementedError(
            "int8 .brq export is defined for the tanh-MLP PPO policy; "
            "use `quantize` (TFLite int8) for off-policy actors")
    save_brq(quant.quantize_policy(params), path)
    return path


def save_brq(qm, path):
    np.savez(path,
             in_scale=qm.in_q.scale, in_zp=qm.in_q.zero_point,
             out_scale=qm.out_q.scale, out_zp=qm.out_q.zero_point,
             w0=qm.w[0], w1=qm.w[1], w2=qm.w[2],
             b0=qm.b[0], b1=qm.b[1], b2=qm.b[2],
             ws0=qm.w_scale[0], ws1=qm.w_scale[1], ws2=qm.w_scale[2],
             a0s=qm.act_q[0].scale, a0z=qm.act_q[0].zero_point,
             a1s=qm.act_q[1].scale, a1z=qm.act_q[1].zero_point,
             a2s=qm.act_q[2].scale, a2z=qm.act_q[2].zero_point)


def load_brq(path):
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as f:
        return QuantizedMLP(
            in_q=QuantTensor(float(f["in_scale"]), int(f["in_zp"])),
            w=(f["w0"], f["w1"], f["w2"]),
            b=(f["b0"], f["b1"], f["b2"]),
            w_scale=(float(f["ws0"]), float(f["ws1"]), float(f["ws2"])),
            act_q=(QuantTensor(float(f["a0s"]), int(f["a0z"])),
                   QuantTensor(float(f["a1s"]), int(f["a1z"])),
                   QuantTensor(float(f["a2s"]), int(f["a2z"]))),
            out_q=QuantTensor(float(f["a2s"]), int(f["a2z"])))
