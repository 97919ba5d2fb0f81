"""int8 post-training quantization and batched int8 inference.

Counterpart of `balance_robot_tpu/ops/quant.py`:

  * `quantize_policy`: the int8 artifact of a pi-network (numpy): weights
    int8 symmetric per tensor, biases int32 at scale in * w, activations
    int8 affine, calibrated on the reference's 3-row representative set;
  * `int8_forward`: batched integer-arithmetic inference on torch tensors,
    with the artifact's float32 round-half-to-even requantization;
  * `quantize_obs` / `dequantize_action` with the reference's
    round-then-clip-to-[-128, 127] semantics;
  * `int8_policy_fn`: float obs (B, 6) -> float actions (B, 2) through the
    whole int8 path, as the hierarchical move env runs it inside `step`.

CUDA has no integer matrix product, so the accumulators are computed in
float32 on the exact integer values: every |accumulator| is checked to be
below 2^24 when an artifact is put on a device, so each product and each
partial sum is an integer that float32 holds exactly, in any summation
order. TF32 is kept off for the product.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch

# the reference's representative dataset (quantize_tflite.py:9-13)
REPRESENTATIVE_OBS = np.array([
    [-3.14 / 2, -6.28, -4, -4, -4, -4],
    [0, 0, 0, 0, 0, 0],
    [3.14 / 2, 6.28, 4, 4, 4, 4],
], np.float32)


class QuantTensor(NamedTuple):
    scale: float
    zero_point: int


class QuantizedMLP(NamedTuple):
    """int8 artifact of the actor network 6 -> 64 -> 64 -> 2 (numpy)."""
    in_q: QuantTensor
    w: tuple            # 3 int8 weight matrices
    b: tuple            # 3 int32 biases
    w_scale: tuple      # 3 python floats
    act_q: tuple        # quant params after each layer (h1, h2, out)
    out_q: QuantTensor  # == act_q[-1]


def _affine_range(lo, hi):
    """TFLite-style asymmetric int8 affine params with zero exactly
    representable."""
    lo = min(float(lo), 0.0)
    hi = max(float(hi), 0.0)
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    zp = int(round(-128 - lo / scale))
    zp = max(-128, min(127, zp))
    return QuantTensor(scale=scale, zero_point=zp)


def quantize_policy(params, rep_obs=REPRESENTATIVE_OBS):
    """Post-training int8 quantization of the pi network of `params`, a
    dict of numpy arrays with the keys pi_w1 .. pi_bout."""
    W = [np.asarray(params[k]) for k in ("pi_w1", "pi_w2", "pi_wout")]
    B = [np.asarray(params[k]) for k in ("pi_b1", "pi_b2", "pi_bout")]
    in_q = _affine_range(np.min(rep_obs), np.max(rep_obs))
    h1 = np.tanh(rep_obs @ W[0] + B[0])
    h2 = np.tanh(h1 @ W[1] + B[1])
    out = h2 @ W[2] + B[2]
    # tanh outputs are in [-1, 1]: TFLite pins their scale to 1/128
    tanh_q = QuantTensor(scale=1.0 / 128.0, zero_point=0)
    act_q = (tanh_q, tanh_q, _affine_range(np.min(out), np.max(out)))

    wq, bq, wsc = [], [], []
    scales_in = [in_q.scale, act_q[0].scale, act_q[1].scale]
    for i in range(3):
        s = float(np.max(np.abs(W[i])) / 127.0) or 1.0
        wq.append(np.clip(np.round(W[i] / s), -127, 127).astype(np.int8))
        wsc.append(s)
        bq.append(np.round(B[i] / (s * scales_in[i])).astype(np.int32))
    return QuantizedMLP(in_q=in_q, w=tuple(wq), b=tuple(bq),
                        w_scale=tuple(wsc), act_q=act_q, out_q=act_q[2])


# ------------------------------------------------------------------ runtime

class DeviceLayers(NamedTuple):
    """A QuantizedMLP's tensors on one device, for `int8_forward`."""
    w: tuple            # 3 float32 matrices holding the int8 weights
    b: tuple            # 3 float32 vectors holding the int32 biases
    zp: tuple           # input zero point of each layer
    eff: tuple          # 3 requantization multipliers, rounded to float32
    in_q: QuantTensor   # its scale a 0-dim float32 tensor on the device
    out_q: QuantTensor


def device_layers(qm: QuantizedMLP, device) -> DeviceLayers:
    """Put `qm` on `device`. Raises unless every accumulator stays below
    2^24 in magnitude, which is what makes the float32 product exact."""
    scales_in = (qm.in_q.scale, qm.act_q[0].scale, qm.act_q[1].scale)
    for w, b in zip(qm.w, qm.b):
        worst = np.abs(w.astype(np.int64)).sum(0) * 255 + np.abs(
            b.astype(np.int64))
        if worst.max() >= 2 ** 24:
            raise ValueError("int8 artifact: an accumulator can reach "
                             f"{worst.max()} >= 2^24, not exact in float32")
    eff = [scales_in[i] * qm.w_scale[i] for i in range(3)]
    eff[2] = eff[2] / qm.out_q.scale
    return DeviceLayers(
        w=tuple(torch.tensor(w, dtype=torch.float32, device=device)
                for w in qm.w),
        b=tuple(torch.tensor(b, dtype=torch.float32, device=device)
                for b in qm.b),
        zp=(qm.in_q.zero_point, 0, 0),
        # a python scalar times a float32 array is a float32 product
        eff=tuple(float(np.float32(e)) for e in eff),
        in_q=qm.in_q._replace(scale=torch.tensor(
            qm.in_q.scale, dtype=torch.float32, device=device)),
        out_q=qm.out_q)


@contextlib.contextmanager
def _full_float32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def int8_forward(layers, q_obs):
    """Batched int8 inference: q_obs int8 (..., 6) -> int8 actions (..., 2).

    `layers` is a DeviceLayers on q_obs's device, or a QuantizedMLP (put on
    that device for this call). Per layer: exact integer accumulator,
    scaled in float32, then tanh, * 128, round half to even, clip for the
    hidden layers, and round, + zero point, clip for the output.
    """
    if isinstance(layers, QuantizedMLP):
        layers = device_layers(layers, q_obs.device)
    x = q_obs.to(torch.float32)
    with _full_float32_matmul():
        for i in range(3):
            acc = (x - layers.zp[i]) @ layers.w[i] + layers.b[i]
            if i < 2:
                pre = acc * layers.eff[i]
                x = torch.round(torch.tanh(pre) * 128.0).clamp(-128, 127)
            else:
                x = (torch.round(acc * layers.eff[i])
                     + layers.out_q.zero_point).clamp(-128, 127)
    return x.to(torch.int8)


def quantize_obs(obs, q: QuantTensor):
    """round(obs / scale) + zero point, clipped to [-128, 127] (the clip
    guards int8 wraparound), in float32.

    The divisor is a tensor, never a python scalar: on CUDA a division by a
    scalar is evaluated as a product with its reciprocal, which rounds
    differently on the boundaries. `q.scale` may already be one."""
    scale = torch.as_tensor(q.scale, dtype=torch.float32, device=obs.device)
    q_ = torch.round(obs.to(torch.float32) / scale) + q.zero_point
    return q_.clamp(-128, 127).to(torch.int8)


def dequantize_action(q_act, q: QuantTensor):
    """scale * (q - zero_point), float32."""
    return float(np.float32(q.scale)) * (q_act.to(torch.float32)
                                         - q.zero_point)


def int8_policy_fn(qm: QuantizedMLP, device):
    """float obs (B, 6) -> float32 actions (B, 2) through the whole int8
    path on `device`; the artifact is put there once."""
    layers = device_layers(qm, device)

    def fn(obs):
        q_act = int8_forward(layers, quantize_obs(obs, layers.in_q))
        return dequantize_action(q_act, layers.out_q)
    return fn
