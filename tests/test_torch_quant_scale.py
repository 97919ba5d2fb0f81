"""torch's CPU int8 path held to exact integer arithmetic at a serving batch.

`ops/quant.py::int8_forward` computes each layer's accumulator in float32
on exact integers below 2^24, so with the same tanh it must give the bits
of an int64-accumulator reference in numpy on any number of obs and at any
thread count (a threaded float32 product sums in another order, which is
exact only if every partial sum is an integer below 2^24). The reference
is the arithmetic of `chip_smoke.int8_exact`, kept here as a copy; the
obs are 4096 uniform draws in [-3, 3] from seed 11, as chip_smoke.py
draws them. tanh is numpy's on both sides, so nothing may differ.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from balance_robot_tpu_torch.envs.move import INNER_POLICY_ASSET
from balance_robot_tpu_torch.export.pipeline import load_brq
from balance_robot_tpu_torch.ops import quant

N_OBS = 4096


def int64_reference(qm, obs):
    """The int8 policy on float32 obs (N, 6): int64 accumulators, the
    float32 scalings, roundings (half to even) and clips of ops/quant.py,
    numpy's float32 tanh. Returns the dequantized actions (N, 2)."""
    f32 = np.float32
    scales_in = (qm.in_q.scale, qm.act_q[0].scale, qm.act_q[1].scale)
    eff = [f32(scales_in[i] * qm.w_scale[i]) for i in range(3)]
    eff[2] = f32(scales_in[2] * qm.w_scale[2] / qm.out_q.scale)
    x = np.clip(np.round(obs.astype(f32) / f32(qm.in_q.scale))
                + qm.in_q.zero_point, -128, 127).astype(np.int64)
    zp = (qm.in_q.zero_point, 0, 0)
    for i in range(3):
        acc = ((x - zp[i]) @ qm.w[i].astype(np.int64)
               + qm.b[i].astype(np.int64)).astype(f32)
        if i < 2:
            x = np.clip(np.round(np.tanh(acc * eff[i]) * f32(128.0)),
                        -128, 127).astype(np.int64)
        else:
            x = np.clip(np.round(acc * eff[i]) + qm.out_q.zero_point,
                        -128, 127)
    return f32(qm.out_q.scale) * (x.astype(f32) - f32(qm.out_q.zero_point))


def numpy_tanh(x):
    return torch.from_numpy(np.tanh(x.numpy()))


@pytest.mark.parametrize("threads", [os.cpu_count(), 1],
                         ids=["default-threads", "one-thread"])
def test_int8_forward_is_exact_at_4096_obs(threads):
    qm = load_brq(INNER_POLICY_ASSET)
    obs = np.random.default_rng(11).uniform(-3, 3, (N_OBS, 6)).astype(
        np.float32)
    exact = torch.from_numpy(int64_reference(qm, obs))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with mock.patch.object(torch, "tanh", numpy_tanh):
            mine = quant.int8_policy_fn(qm, "cpu")(torch.from_numpy(obs))
    finally:
        torch.set_num_threads(before)
    bad = (mine != exact).any(1).nonzero().flatten().tolist()
    assert not bad, (f"{len(bad)} of {N_OBS} obs differ at {threads} "
                     f"threads, first {bad[:5]}")
