"""The port's checkpoint dispatch, checkpoint sweep and large policy eval
(`train/selection.py::act_fn_for`, `train/sweep.py`,
`train/eval_policy.py`) against the JAX tools, on the CPU.

  * `act_fn_for` against `tools/eval_policy.py:50-92`'s dispatch, written
    out here with the JAX package's functions, on the same obs: the PPO,
    SAC, TD3 and DDPG checkpoints of Env01-v2 and the privileged-obs
    teacher of Env03-v2 in float64 (within 1e-12), and the int8 deployment
    path (equal);
  * the sweep's order, ranking and JSON on three checkpoints of a toy env
    (obs = [x, ...], x pushed by the second action): the tool's keys, each
    row equal to a paired eval of its checkpoint;
  * the eval's recoverable split on Env01-v2 at a one-step horizon: the
    start pitches are those of the reset the evaluator stepped.
"""

import json
import shutil
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.envs.privileged import PrivilegedObsEnv as JPrivEnv
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.ops import quant as jquant
from balance_robot_tpu.train.offpolicy import _apply_mlp

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs.base import TERMINATE_PITCH, pitch_of
from balance_robot_tpu_torch.envs.privileged import PrivilegedObsEnv
from balance_robot_tpu_torch.train import checkpoint, eval_policy, sweep
from balance_robot_tpu_torch.train import selection
from balance_robot_tpu_torch.train.ppo import fork_env

torch.set_num_threads(1)
F64 = torch.float64
MODELS = Path(__file__).resolve().parents[1] / "models"


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_tool_act(params, obs_dim, act_dim):
    """tools/eval_policy.py's act fn of a checkpoint, as the tool builds
    it (its teacher test, then the off-policy and PPO branches)."""
    if "pi_w1" in params and params["pi_w1"].shape[0] > obs_dim:
        assert params["pi_w1"].shape[0] == obs_dim + 8
    if any(k.startswith("actor/") for k in params):
        n_layers = 1 + max(int(k.split("/")[1]) for k in params
                           if k.startswith("actor/"))
        actor = [{"w": jnp.asarray(params[f"actor/{i}/w"]),
                  "b": jnp.asarray(params[f"actor/{i}/b"])}
                 for i in range(n_layers)]
        sac = actor[-1]["b"].shape[-1] == 2 * act_dim

        def _op_act(p, o):
            out = _apply_mlp(actor, o)
            if sac:
                mean, _ = jnp.split(out, 2, axis=-1)
                return jnp.tanh(mean)
            return jnp.clip(jnp.tanh(out), -1.0, 1.0)
        return _op_act
    return lambda p, o: jnp.clip(jmlp.policy_mean(p, o), -1.0, 1.0)


CHECKPOINTS = {"PPO": ("Env01-v2", "Env01-v2_PPO"),
               "SAC": ("Env01-v2", "Env01-v2_SAC"),
               "TD3": ("Env01-v2", "Env01-v2_TD3"),
               "DDPG": ("Env01-v2", "Env01-v2_DDPG"),
               "teacher": ("Env03-v2", "Env03-v2_teacher")}


@pytest.mark.parametrize("kind", sorted(CHECKPOINTS))
def test_act_fn_for_matches_the_jax_tools_dispatch(x64, kind):
    env_id, name = CHECKPOINTS[kind]
    params = {k: v.astype(np.float64) for k, v in checkpoint.load(
        MODELS / name / "best_model.npz").items()}
    env = brt.make(env_id, device="cpu", dtype=F64)
    ev_env, act, policy = selection.act_fn_for(params, env)
    assert isinstance(ev_env, PrivilegedObsEnv) == (kind == "teacher")
    assert ev_env.obs_dim == (14 if kind == "teacher" else 6)
    if kind == "teacher":
        assert JPrivEnv(jbrt.make(env_id)).obs_dim == ev_env.obs_dim
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(128, ev_env.obs_dim)) * 0.6
    with torch.no_grad():
        mine = act(policy, torch.tensor(obs))
    ref = jax_tool_act(params, 6, 2)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(obs))
    assert mine.dtype == F64 and mine.shape == (128, 2)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=1e-12)
    assert np.abs(np.asarray(ref)).max() > 0.1       # the policy acts


def test_act_fn_for_int8_matches_the_jax_tool():
    params = checkpoint.load(MODELS / "Env01-v2_PPO" / "best_model.npz")
    env = brt.make("Env01-v2", device="cpu")
    ev_env, act, policy = selection.act_fn_for(params, env, int8=True)
    assert ev_env is env
    rng = np.random.default_rng(8)
    obs = (rng.normal(size=(256, 6)) * 0.6).astype(np.float32)
    mine = act(policy, torch.tensor(obs))
    fn = jquant.int8_policy_fn(jquant.quantize_policy(params))
    ref = np.asarray(jax.vmap(fn)(jnp.asarray(obs)))
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert len(np.unique(ref)) > 10


# ---------------------------------------------------------------- sweep

class ToyState(NamedTuple):
    t: torch.Tensor
    x: torch.Tensor


class ToyEnv:
    """x starts in [-0.1, 0.1) and moves by 0.3 a1 + 0.2 (u - 0.5) per
    step; reward 1 - |x|; terminated at |x| > 1, truncated at 8 steps."""

    id = "Toy-v0"
    obs_dim = 6
    act_dim = 2
    max_episode_steps = 8

    def __init__(self, device=None, dtype=torch.float32, seed=0):
        self.device, self.dtype = torch.device(device or "cpu"), dtype
        self.generator = torch.Generator().manual_seed(seed)

    def use_fast_solver(self):
        return self

    def _obs(self, s):
        z = torch.zeros_like(s.x)
        return torch.stack([s.x, z, z, z, z, z], -1).float()

    def reset(self, n):
        x = (torch.rand(n, generator=self.generator) - 0.5) * 0.2
        s = ToyState(t=torch.zeros(n, dtype=torch.int32), x=x)
        return s, self._obs(s)

    def step(self, s, action, uniforms=None):
        u = torch.rand(action.shape[0], generator=self.generator)
        x = s.x + 0.3 * action[:, 1] + 0.2 * (u - 0.5)
        s = ToyState(t=s.t + 1, x=x)
        return (s, self._obs(s), 1.0 - s.x.abs(), x.abs() > 1.0,
                s.t >= self.max_episode_steps)


def pushed(bias):
    """models/Env01-v2_PPO with its second action's bias moved by
    `bias`."""
    p = checkpoint.load(MODELS / "Env01-v2_PPO" / "best_model.npz")
    p["pi_bout"] = p["pi_bout"] + np.array([0.0, bias], np.float32)
    return p


def test_sweep_orders_ranks_and_writes_the_tools_rows(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setitem(brt._REGISTRY, ToyEnv.id, ToyEnv)
    run = tmp_path / "run"
    biases = {"cp_100.npz": 0.4, "cp_20.npz": 0.0, "best_model.npz": 0.2,
              "cp_300.npz": 5.0}
    for fname, bias in biases.items():
        checkpoint.save(run / fname, pushed(bias))
    out = tmp_path / "sweep.json"
    rows = sweep.main([str(run), "--env", ToyEnv.id, "--episodes", "32",
                       "--seed", "4", "--every", "2", "--out", str(out),
                       "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "3 checkpoints, 32 episodes each, horizon 8 (cpu)" in printed
    # step order, every 2nd numbered checkpoint, then the named ones
    order = [line.split()[0] for line in printed.splitlines()
             if line.startswith("  ")]
    assert order == ["cp_20.npz", "cp_300.npz", "best_model.npz"]
    assert json.loads(out.read_text()) == rows
    assert [set(r) for r in rows] == [{"ckpt", "full_horizon",
                                       "mean_return", "mean_len",
                                       "median_len"}] * 3
    keys = [(r["full_horizon"], r["mean_len"]) for r in rows]
    assert keys == sorted(keys, reverse=True) and len(set(keys)) == 3
    assert rows[-1]["ckpt"] == "cp_300.npz"   # pushed out at once
    env = ToyEnv()
    for r in rows:
        ev_env, act, policy = selection.act_fn_for(
            checkpoint.load(run / r["ckpt"]), env)
        full, ret, length, _, lens = selection.paired_eval(
            ev_env, act, policy, 4, 32)
        assert (r["full_horizon"], r["mean_return"], r["mean_len"],
                r["median_len"]) == (full, ret, length,
                                     float(np.median(lens)))
    assert sweep.checkpoints(run) == [run / "cp_20.npz", run / "cp_100.npz",
                                      run / "cp_300.npz",
                                      run / "best_model.npz"]


# ----------------------------------------------------------------- eval

def test_eval_splits_by_the_start_pitch_of_the_stepped_reset(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    make = brt.make

    def one_step(env_id, **kw):
        env = make(env_id, **kw)
        env.max_episode_steps = 1
        return env

    monkeypatch.setattr(brt, "make", one_step)
    model = tmp_path / "ppo.npz"
    shutil.copy(MODELS / "Env01-v2_PPO" / "best_model.npz", model)
    dump = tmp_path / "dump.npz"
    ret, lens, p0 = eval_policy.main([str(model), "--env", "Env01-v2",
                                      "--episodes", "48", "--seed", "2",
                                      "--dump", str(dump), "--device",
                                      "cpu"])
    printed = capsys.readouterr().out
    states, _ = fork_env(one_step("Env01-v2", device="cpu"), 2).reset(48)
    np.testing.assert_array_equal(p0, pitch_of(states.phys.qpos).numpy())
    saved = np.load(dump)
    np.testing.assert_array_equal(saved["p0"], p0)
    np.testing.assert_array_equal(saved["lens"], lens)
    np.testing.assert_array_equal(saved["ret"], ret)
    assert int(saved["seed"]) == 2
    rec = np.abs(p0) < TERMINATE_PITCH
    assert 0 < (~rec).sum() < rec.sum()
    assert f"recoverable starts     n={int(rec.sum()):4d}" in printed
    assert f"unrecoverable starts   n={int((~rec).sum()):4d}" in printed
    assert "(48 deterministic episodes, horizon 1)" in printed
    assert (lens == 1).all() and np.isfinite(ret).all()
    # the teacher goes through its privileged view
    eval_policy.main([str(MODELS / "Env03-v2_teacher" / "best_model.npz"),
                      "--env", "Env03-v2", "--episodes", "2",
                      "--device", "cpu"])
    assert "[teacher checkpoint: evaluating through PrivilegedObsEnv " \
        "(14-obs)]" in capsys.readouterr().out
