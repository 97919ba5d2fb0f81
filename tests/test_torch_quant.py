"""The port's int8 simulator and `.brq` files against the JAX package (CPU).

Same inputs (numpy, from a seed) through `balance_robot_tpu.ops.quant` and
`balance_robot_tpu_torch.ops.quant`. Quantizing a policy is numpy on both
sides: integers must be equal and the scales agree to 1e-15. The int8
forward computes exact integer accumulators on both sides (int32 in JAX,
float32 below 2^24 in the port) and requantizes in float32; the only
inexact step is `tanh`, whose last ulp may differ between the two
libraries, so an int8 output may differ by one step on a rounding boundary:
at most 1 LSB on at most 0.1% of the entries.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import balance_robot_tpu
from balance_robot_tpu.export import pipeline as jpipeline
from balance_robot_tpu.ops import quant as jquant

import balance_robot_tpu_torch
from balance_robot_tpu_torch.envs.move import INNER_POLICY_ASSET
from balance_robot_tpu_torch.export import pipeline
from balance_robot_tpu_torch.ops import quant

torch.set_num_threads(1)
JAX_ASSET = (Path(balance_robot_tpu.__file__).parent / "envs" / "assets"
             / "inner_policy.brq.npz")


def policy_params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dims = (6, 64, 64, 2)
    names = ("1", "2", "out")
    params = {}
    for name, n_in, n_out in zip(names, dims, dims[1:]):
        params[f"pi_w{name}"] = (rng.normal(size=(n_in, n_out))
                                 / np.sqrt(n_in)).astype(dtype)
        params[f"pi_b{name}"] = (rng.normal(size=n_out) * 0.1).astype(dtype)
    return params


def assert_same_artifact(mine, ref, scale_tol=0.0):
    for a, b in zip(mine.w + mine.b, ref.w + ref.b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mine.w_scale, ref.w_scale, rtol=0,
                               atol=scale_tol)
    for a, b in zip((mine.in_q, mine.out_q) + tuple(mine.act_q),
                    (ref.in_q, ref.out_q) + tuple(ref.act_q)):
        assert a.zero_point == b.zero_point
        assert abs(a.scale - b.scale) <= scale_tol


def test_the_packaged_asset_is_the_jax_packages():
    assert INNER_POLICY_ASSET.parent.parent.parent == Path(
        balance_robot_tpu_torch.__file__).parent
    assert filecmp.cmp(INNER_POLICY_ASSET, JAX_ASSET, shallow=False)


@pytest.mark.parametrize("seed,dtype", [(0, np.float32), (1, np.float64)])
def test_quantize_policy_matches_jax(seed, dtype):
    params = policy_params(seed, dtype)
    mine = quant.quantize_policy(params)
    ref = jquant.quantize_policy(params)
    assert_same_artifact(mine, ref, scale_tol=1e-15)
    assert mine.w[0].dtype == np.int8 and mine.b[0].dtype == np.int32
    assert mine.act_q[0] == mine.act_q[1] == (1.0 / 128.0, 0)
    assert mine.out_q == mine.act_q[2]
    np.testing.assert_array_equal(quant.REPRESENTATIVE_OBS,
                                  jquant.REPRESENTATIVE_OBS)


def assert_int8_close(mine, ref):
    """Equal, but for 1 LSB on at most 0.1% of the entries (a tanh ulp on a
    rounding boundary)."""
    assert mine.dtype == np.int8 and ref.dtype == np.int8
    diff = np.abs(mine.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() <= 1e-3, (diff != 0).mean()


@pytest.mark.parametrize("source", ["asset", "seeded"])
def test_int8_forward_matches_jax(source):
    qm = (pipeline.load_brq(INNER_POLICY_ASSET) if source == "asset"
          else quant.quantize_policy(policy_params(2)))
    rng = np.random.default_rng(4)
    q_obs = rng.integers(-128, 128, size=(4096, 6)).astype(np.int8)
    ref = np.asarray(jquant.int8_forward(qm, jnp.asarray(q_obs)))
    mine = quant.int8_forward(qm, torch.tensor(q_obs)).numpy()
    assert mine.shape == (4096, 2)
    assert_int8_close(mine, ref)
    # the outputs are not a constant: the comparison means something
    assert len(np.unique(ref)) > 20


def test_int8_policy_fn_matches_jax():
    qm = pipeline.load_brq(INNER_POLICY_ASSET)
    rng = np.random.default_rng(5)
    obs = rng.uniform(-3, 3, size=(2048, 6)).astype(np.float32)
    import jax
    ref = np.asarray(jax.vmap(jquant.int8_policy_fn(qm))(jnp.asarray(obs)))
    mine = quant.int8_policy_fn(qm, "cpu")(torch.tensor(obs))
    assert mine.dtype == torch.float32 and mine.shape == (2048, 2)
    step = np.float32(qm.out_q.scale)
    diff = np.abs(mine.numpy() - ref)
    assert diff.max() <= step * 1.0001
    assert (diff != 0).mean() <= 1e-3
    # float64 obs (the env's parity dtype) are narrowed first, as in JAX
    wide = quant.int8_policy_fn(qm, "cpu")(torch.tensor(obs, dtype=torch.float64))
    np.testing.assert_array_equal(wide.numpy(), mine.numpy())


def test_quantize_obs_clips_and_rounds_half_to_even():
    q = quant.QuantTensor(scale=0.5, zero_point=3)
    obs = np.array([0.25, 0.75, 1.25, -0.25, -0.75, 1e6, -1e6, 61.9, 62.1,
                    -65.4, -65.6, 0.0], np.float32)
    mine = quant.quantize_obs(torch.tensor(obs), q)
    assert mine.dtype == torch.int8
    # obs / 0.5 = .5, 1.5, 2.5, -.5, -1.5 round to 0, 2, 2, -0, -2
    assert mine.tolist() == [3, 5, 5, 3, 1, 127, -128, 127, 127, -128, -128,
                             3]
    ref = np.asarray(jquant.quantize_obs(jnp.asarray(obs), q))
    np.testing.assert_array_equal(mine.numpy(), ref)
    # the packaged artifact's own scale, on a dense sweep with boundaries
    qm = pipeline.load_brq(INNER_POLICY_ASSET)
    k = np.arange(-300, 300, dtype=np.float32)
    sweep = np.concatenate([(k + 0.5) * np.float32(qm.in_q.scale),
                            np.random.default_rng(6).uniform(
                                -8, 8, 4000).astype(np.float32)])
    np.testing.assert_array_equal(
        quant.quantize_obs(torch.tensor(sweep), qm.in_q).numpy(),
        np.asarray(jquant.quantize_obs(jnp.asarray(sweep), qm.in_q)))
    deq = quant.dequantize_action(torch.tensor([-128, 0, 7, 127],
                                               dtype=torch.int8), qm.out_q)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jquant.dequantize_action(
            jnp.asarray([-128, 0, 7, 127], jnp.int8), qm.out_q)))


def test_brq_files_cross_load(tmp_path):
    qm = jquant.quantize_policy(policy_params(3))
    jpipeline.save_brq(qm, tmp_path / "from_jax.brq")
    mine = pipeline.load_brq(tmp_path / "from_jax.brq")
    assert isinstance(mine, quant.QuantizedMLP)
    assert_same_artifact(mine, qm)
    pipeline.save_brq(mine, tmp_path / "from_port.brq")
    back = jpipeline.load_brq(tmp_path / "from_port.brq.npz")
    assert_same_artifact(back, qm)
    with np.load(tmp_path / "from_jax.brq.npz") as a, \
            np.load(tmp_path / "from_port.brq.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    # both packages compute the same actions from the file
    q_obs = np.random.default_rng(7).integers(-128, 128, (512, 6)).astype(
        np.int8)
    assert_int8_close(
        quant.int8_forward(mine, torch.tensor(q_obs)).numpy(),
        np.asarray(jquant.int8_forward(back, jnp.asarray(q_obs))))


def test_an_artifact_that_float32_cannot_hold_exactly_is_refused():
    qm = pipeline.load_brq(INNER_POLICY_ASSET)
    big = qm._replace(b=(qm.b[0] + np.int32(2 ** 24),) + qm.b[1:])
    with pytest.raises(ValueError, match="2\\^24"):
        quant.device_layers(big, "cpu")
    quant.device_layers(qm, "cpu")
