"""The frozen int8 inner balance policy of EnvMove05-v1 (a `.brq` artifact,
6 -> 64 -> 64 -> 2), written out plainly.

The artifact is read with numpy. Its arithmetic is the one the artifact
defines (TFLite's int8 kernels, as the reference project's Teensy runs
them):

  * quantize: round(obs / in_scale), half to even, + in_zp, clipped to
    [-128, 127], on the float32 obs with a float32 scale;
  * each layer: an integer accumulator (x - zp) @ W + b, here held in
    float64, which represents every such integer exactly;
  * requantize: the accumulator times the layer's multiplier (input scale x
    weight scale, over the output scale for the last layer), a float32
    number, in float32; hidden layers then take tanh, x 128, round half to
    even, clip; the output layer rounds, adds its zero point and clips;
  * dequantize: out_scale x (q - out_zp) in float32.

Departure: tanh is taken in float64 and rounded once to float32, the
correctly rounded float32 tanh, where a float32 tanh of a library may be an
ulp or two off. Where a tanh x 128 lies that close to a half-integer, the
program and this reference pick neighbouring integers for a real reason.
"""

import numpy as np
import torch

F32 = torch.float32


def load(path):
    """The artifact at `path` as a dict: in / out (scale, zero point) and
    per layer (W int8 (in, out), b int32, zero point of its input, its
    requantization multiplier rounded to float32), numpy."""
    with np.load(path) as f:
        a = {k: f[k] for k in f.files}
    scales_in = (float(a["in_scale"]), float(a["a0s"]), float(a["a1s"]))
    mult = [scales_in[i] * float(a[f"ws{i}"]) for i in range(3)]
    mult[2] = mult[2] / float(a["a2s"])
    return dict(
        in_scale=float(a["in_scale"]), in_zp=int(a["in_zp"]),
        out_scale=float(a["a2s"]), out_zp=int(a["a2z"]),
        layers=[dict(w=a[f"w{i}"], b=a[f"b{i}"],
                     zp=int(a["in_zp"]) if i == 0 else int(a[f"a{i - 1}z"]),
                     mult=float(np.float32(mult[i])))
                for i in range(3)])


def quantize(art, obs):
    """float obs (B, 6) -> int8 (B, 6) (a float64 tensor of integers)."""
    scale = torch.tensor(art["in_scale"], dtype=F32, device=obs.device)
    q = torch.round(obs.to(F32) / scale) + art["in_zp"]
    return q.clamp(-128, 127).to(torch.float64)


def forward(art, q):
    """int8 inputs (B, 6) -> int8 outputs (B, 2), float64 tensors of
    integers."""
    x = q.to(torch.float64)
    for i, layer in enumerate(art["layers"]):
        w = torch.as_tensor(layer["w"], dtype=torch.float64, device=x.device)
        b = torch.as_tensor(layer["b"], dtype=torch.float64, device=x.device)
        acc = (x - layer["zp"]) @ w + b
        pre = acc.to(F32) * torch.tensor(layer["mult"], dtype=F32,
                                         device=x.device)
        if i < 2:
            t = torch.tanh(pre.to(torch.float64)).to(F32)
            x = torch.round(t * 128.0).clamp(-128, 127)
        else:
            x = (torch.round(pre) + art["out_zp"]).clamp(-128, 127)
        x = x.to(torch.float64)
    return x


def dequantize(art, q):
    """int8 outputs (B, 2) -> float32 actions."""
    scale = torch.tensor(art["out_scale"], dtype=F32, device=q.device)
    return scale * (q.to(F32) - art["out_zp"])


def act(art, obs):
    """float obs (B, 6) -> float32 actions (B, 2) through the int8 path."""
    return dequantize(art, forward(art, quantize(art, obs)))
