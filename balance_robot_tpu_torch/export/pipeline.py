"""The `.brq` int8 artifact on disk.

Counterpart of `save_brq` / `load_brq` of
`balance_robot_tpu/export/pipeline.py`: the same npz key layout, so an
artifact written by either package loads in the other. The rest of the
export chain (ONNX, TFLite, model.h) is not ported yet.
"""

import numpy as np

from ..ops.quant import QuantizedMLP, QuantTensor


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
