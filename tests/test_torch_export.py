"""The port's export chain against the JAX package's (CPU).

The same checkpoints (the repo's `models/`) and the same numpy inputs go
through `balance_robot_tpu.export` and `balance_robot_tpu_torch.export`:

  * the `.onnx` files are byte-identical, and equal the committed ones
    where the repo has them;
  * the numpy and native ONNX sessions agree with the JAX package's and
    with the port's `policy_mean` to 1e-6 (float32; the value, up to ~200,
    to 1e-5 relative);
  * the `.brq` arrays are equal, and the native int8 runtime gives the
    same int8 codes as both packages' `int8_forward`, bit for bit;
  * the off-policy head is read by `act_dim`, where the JAX package
    assumes 2 actions.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from balance_robot_tpu.export import onnx_runtime as jrt
from balance_robot_tpu.export import pipeline as jpipeline
from balance_robot_tpu.ops import quant as jquant

from balance_robot_tpu_torch import cli
from balance_robot_tpu_torch.export import native_runtime, onnx_runtime
from balance_robot_tpu_torch.export import onnx_writer, pipeline
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.ops import quant
from balance_robot_tpu_torch.train import checkpoint

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "models"
CHECKPOINTS = ["Env01-v2_PPO", "Env01-v2_SAC", "Env01-v2_TD3",
               "Env01-v2_DDPG", "Env03-v2_r2i", "privileged"]


def load(name):
    """The params of `models/<name>/best_model`, or for "privileged" the
    Env01-v2 PPO policy with its critic widened to 14 inputs (random
    privileged rows, as a trained privileged critic has)."""
    if name != "privileged":
        return checkpoint.load(MODELS / name / "best_model")
    params = mlp.pad_privileged_critic(load("Env01-v2_PPO"), 14)
    w = params["vf_w1"].copy()
    w[6:] = np.random.default_rng(3).normal(size=w[6:].shape)
    return {**params, "vf_w1": w}


@pytest.fixture(scope="module")
def obs():
    return np.random.default_rng(0).uniform(-3, 3, (64, 6)).astype(
        np.float32)


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_onnx_bytes_equal_the_jax_packages(tmp_path, name):
    params = load(name)
    mine = pipeline.export_onnx(params, tmp_path / "port.onnx", act_dim=2)
    ref = jpipeline.export_onnx(params, tmp_path / "jax.onnx")
    assert mine.read_bytes() == ref.read_bytes()
    committed = MODELS / name / "best_model.onnx"
    if name in ("Env01-v2_PPO", "Env01-v2_SAC"):
        assert mine.read_bytes() == committed.read_bytes()
    onnx_runtime.check_model(onnx_runtime.load_model(mine))


@pytest.mark.parametrize("name", ["Env01-v2_PPO", "Env03-v2_r2i",
                                  "Env01-v2_TD3", "Env01-v2_SAC"])
def test_sessions_match_jax_and_the_policy(tmp_path, name, obs):
    """float32 graphs on the same obs: every leg's actions within 1e-6 of
    the others' and of the policy (2e-6 of a float64 reference for the
    off-policy actors); the value (-5 to ~200) within 1e-5 relative: the
    native executor sums in another order."""
    params = load(name)
    path = pipeline.export_onnx(params, tmp_path / "m.onnx", act_dim=2)
    native = native_runtime.NativeOnnxSession(path)
    assert native.library.parent == native_runtime.BUILD_DIR
    legs = [onnx_runtime.NumpySession(path), native,
            jrt.NumpySession(path)]
    outs = [[o.name for o in s.get_outputs()] for s in legs]
    assert all(o == outs[0] for o in outs) and outs[0][0] == "output"
    if "pi_w1" in params:
        net = mlp.from_numpy_params(mlp.deployable_params(params))
        with torch.no_grad():
            expect = net.policy_mean(torch.from_numpy(obs)).numpy()
            value = net.value(torch.from_numpy(obs)).numpy()
    else:
        # in float64: the float32 graphs are held to it within 2e-6, as
        # tests/test_onnx.py holds the JAX package's
        W, B = pipeline.offpolicy_actor(params)
        x = obs.astype(np.float64)
        for w, b in zip(W[:-1], B[:-1]):
            x = np.maximum(x @ w + b, 0)
        expect = np.tanh((x @ W[-1] + B[-1])[:, :2])
    for i, o in enumerate(obs):
        results = [s.run(None, {"input": o[None]}) for s in legs]
        for res in results:
            np.testing.assert_allclose(res[0][0], expect[i], rtol=0,
                                       atol=1e-6 if "pi_w1" in params
                                       else 2e-6)
            for a, b in zip(res, results[-1]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        if "pi_w1" in params:
            np.testing.assert_allclose(results[0][1][0, 0], value[i],
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError):
        native.run(["output"], {"input": np.zeros((1, 999), np.float32)})


def test_session_takes_the_native_leg(tmp_path):
    path = pipeline.export_onnx(load("Env01-v2_PPO"), tmp_path / "m.onnx",
                                act_dim=2)
    sess = onnx_runtime.session(path)
    assert isinstance(sess, native_runtime.NativeOnnxSession)
    assert sess.library.exists()
    assert sess.library.parent == ROOT / "build" / "torch_native"


def test_checker_rejects_corrupt_graphs():
    """The corrupt graphs of tests/test_onnx.py, through the port's
    checker and parser."""
    blob = onnx_writer.build_policy_onnx(load("Env01-v2_PPO"))
    model = onnx_runtime.load_model(blob)
    nodes = model["graph"]["nodes"]
    bad = {**model, "graph": {**model["graph"], "nodes": [
        {**nodes[0], "input": ["does_not_exist"]}] + nodes[1:]}}
    with pytest.raises(onnx_runtime.OnnxValidationError,
                       match="not produced"):
        onnx_runtime.check_model(bad)
    bad = {**model, "graph": {**model["graph"], "nodes": [
        {**nodes[0], "op_type": "LSTM"}] + nodes[1:]}}
    with pytest.raises(onnx_runtime.OnnxValidationError,
                       match="unsupported"):
        onnx_runtime.check_model(bad)
    with pytest.raises(Exception):
        onnx_runtime.load_model(blob[:len(blob) // 2])


def test_brq_and_int8_codes_equal_the_jax_packages(tmp_path):
    """The .brq of the Env01-v2 policy: equal arrays, and on 1024 obs the
    same int8 codes from the native runtime, the JAX package's
    int8_forward and the port's CPU int8_forward."""
    params = load("Env01-v2_PPO")
    pipeline.export_brq(params, tmp_path / "port.brq")
    jpipeline.export_brq(params, tmp_path / "jax.brq")
    mine, ref = (np.load(tmp_path / f"{n}.brq.npz") for n in ("port", "jax"))
    assert sorted(mine.files) == sorted(ref.files)
    for k in ref.files:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])
    qm = pipeline.load_brq(tmp_path / "port.brq")
    native = native_runtime.NativeInt8Policy(qm)
    assert native.library.parent == native_runtime.BUILD_DIR
    obs = np.random.default_rng(1).uniform(-3, 3, (1024, 6)).astype(
        np.float32)
    q_obs = quant.quantize_obs(torch.from_numpy(obs), qm.in_q)
    codes = np.stack([native.invoke_int8(q) for q in q_obs.numpy()])
    np.testing.assert_array_equal(quant.int8_forward(qm, q_obs).numpy(),
                                  codes)
    jqm = jpipeline.load_brq(tmp_path / "jax.brq")
    np.testing.assert_array_equal(
        np.asarray(jquant.int8_forward(jqm, jnp.asarray(q_obs.numpy()))),
        codes)
    acts = quant.dequantize_action(torch.from_numpy(codes), qm.out_q)
    for i in range(4):
        np.testing.assert_array_equal(native.run(obs[i]), acts[i].numpy())


def test_offpolicy_brq_is_refused(tmp_path):
    with pytest.raises(NotImplementedError):
        pipeline.export_brq(load("Env01-v2_SAC"), tmp_path / "x.brq")
    assert not (tmp_path / "x.brq.npz").exists()


def _actor(head, seed=0):
    rng = np.random.default_rng(seed)
    dims = [(6, 16), (16, 16), (16, head)]
    params = {}
    for i, (m, n) in enumerate(dims):
        params[f"actor/{i}/w"] = rng.normal(size=(m, n)).astype(np.float32)
        params[f"actor/{i}/b"] = rng.normal(size=n).astype(np.float32)
    return params


@pytest.mark.parametrize("head,act_dim,kind", [
    (2, 2, "direct"), (4, 2, "sac"), (4, 4, "direct"), (8, 4, "sac"),
    (3, 2, None), (2, 1, "sac"), (3, 1, None), (6, 2, None)])
def test_the_head_is_read_by_act_dim(tmp_path, head, act_dim, kind):
    """A 4-wide head is SAC at act_dim 2 and TD3/DDPG at act_dim 4 (where
    the JAX package, assuming 2 actions, reads it as SAC); other widths
    raise."""
    params = _actor(head)
    path = tmp_path / "a.onnx"
    if kind is None:
        with pytest.raises(ValueError, match="head of width"):
            pipeline.export_onnx(params, path, act_dim)
        assert not path.exists()
        return
    assert onnx_writer.actor_head(head, act_dim) == kind
    pipeline.export_onnx(params, path, act_dim)
    sess = onnx_runtime.NumpySession(path)
    obs = np.random.default_rng(2).uniform(-1, 1, (1, 6)).astype(np.float32)
    (out,) = sess.run(["output"], {"input": obs})
    x = obs
    for i in range(2):
        x = np.maximum(x @ params[f"actor/{i}/w"] + params[f"actor/{i}/b"], 0)
    x = x @ params["actor/2/w"] + params["actor/2/b"]
    assert out.shape == (1, act_dim)
    np.testing.assert_allclose(out, np.tanh(x[:, :act_dim]), rtol=0,
                               atol=2e-6)
    if head == 4 and act_dim == 2:
        jpath = jpipeline.export_onnx(params, tmp_path / "j.onnx")
        assert jpath.read_bytes() == path.read_bytes()


def test_policy_head_width_must_match(tmp_path):
    with pytest.raises(ValueError, match="policy head"):
        pipeline.export_onnx(load("Env01-v2_PPO"), tmp_path / "p.onnx", 4)


def test_tflite_chain(tmp_path, obs):
    """SavedModel -> int8 and float32 TFLite -> model.h on the Env01-v2
    policy: the same bytes as the JAX package's chain, and the float
    model's actions within 1e-5 of the port's policy mean."""
    tf = pytest.importorskip("tensorflow")
    params = load("Env01-v2_PPO")
    files = {}
    for name, pl, extra in (("port", pipeline, (2,)), ("jax", jpipeline, ())):
        sm = pl.export_savedmodel(params, tmp_path / f"{name}_sm", *extra)
        f32 = pl.quantize_tflite(sm, tmp_path / f"{name}_f32.tflite",
                                 float32=True)
        i8 = pl.quantize_tflite(sm, tmp_path / f"{name}_i8.tflite")
        header = pl.write_model_h(i8, tmp_path / f"{name}_model.h")
        files[name] = (f32, i8, header)
    for mine, ref in zip(*files.values()):
        assert mine.read_bytes() == ref.read_bytes()
    assert files["port"][2].read_text().startswith(
        "unsigned char model[] = {")

    # the CLI's act_fns: the float model within 1e-5 of the port's
    # policy mean; the int8 model within 0.1 of it on obs in +-0.5 (the
    # bound of tests/test_quant.py)
    net = mlp.from_numpy_params(params)
    small = obs[:8] / 6
    with torch.no_grad():
        expect = net.policy_mean(torch.from_numpy(obs[:8])).numpy()
        expect_small = net.policy_mean(torch.from_numpy(small)).numpy()
    act = cli._tflite_act(files["port"][0], quantized=False)
    for o, e in zip(obs[:8], expect):
        np.testing.assert_allclose(act(o), e, rtol=0, atol=1e-5)
    act = cli._tflite_act(files["port"][1], quantized=True)
    for o, e in zip(small, expect_small):
        np.testing.assert_allclose(act(o), e, rtol=0, atol=0.1)
