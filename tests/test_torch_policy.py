"""The port's policy, checkpoints and evaluator against the JAX package.

The MLP runs in float32 on both sides: the products are summed in another
order, so outputs agree to ~1e-7 relative (bound 1e-6). The
slice as a whole (Env01-v2 with the fast solver and the deterministic
policy) runs in float64 end to end and agrees to 1e-8.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.physics import step as jst

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint
from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator

torch.set_num_threads(1)
MODELS = Path(__file__).resolve().parents[1] / "models"
POLICY = MODELS / "Env01-v2_PPO" / "best_model.npz"


def _is_ppo(path):
    with np.load(path) as f:
        return "pi_w1" in f.files


PPO_CHECKPOINTS = sorted(p for p in MODELS.glob("*/best_model.npz")
                         if _is_ppo(p))


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_every_ppo_checkpoint_round_trips():
    assert len(PPO_CHECKPOINTS) >= 20
    for path in PPO_CHECKPOINTS:
        d = checkpoint.load(path)
        net = mlp.from_numpy_params(d, device="cpu")
        back = mlp.to_numpy_params(net)
        assert sorted(back) == sorted(d), path
        for k in d:
            np.testing.assert_array_equal(back[k], d[k], err_msg=str(path))
            assert back[k].dtype == d[k].dtype


def test_checkpoint_save_load(tmp_path):
    net = mlp.ActorCritic(generator=torch.Generator().manual_seed(0))
    checkpoint.save(tmp_path / "a" / "model", mlp.to_numpy_params(net))
    d = checkpoint.load(tmp_path / "a" / "model.npz")
    again = mlp.to_numpy_params(mlp.from_numpy_params(d))
    for k, v in mlp.to_numpy_params(net).items():
        np.testing.assert_array_equal(again[k], v)
    # nested trees (the off-policy layout) flatten to path-joined keys
    checkpoint.save(tmp_path / "nested.npz",
                    {"actor": [{"w": torch.ones(2, 3)}, {"b": np.zeros(3)}],
                     "log_alpha": 0.5})
    flat = checkpoint.load(tmp_path / "nested")
    assert sorted(flat) == ["actor/0/w", "actor/1/b", "log_alpha"]
    assert flat["actor/0/w"].shape == (2, 3)


def test_init_shapes_and_heads():
    g = torch.Generator().manual_seed(0)
    net = mlp.ActorCritic(obs_dim=6, act_dim=2, hidden=64, vf_obs_dim=14,
                          generator=g)
    d = mlp.to_numpy_params(net)
    assert d["pi_w1"].shape == (6, 64) and d["vf_w1"].shape == (14, 64)
    assert d["pi_wout"].shape == (64, 2) and d["vf_wout"].shape == (64, 1)
    # orthogonal columns with the SB3 gains
    w = d["pi_w2"]
    np.testing.assert_allclose(w.T @ w, 2.0 * np.eye(64), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(d["pi_wout"], axis=0), 0.01,
                               rtol=1e-5)
    assert (d["log_std"] == 0).all() and (d["pi_b1"] == 0).all()
    assert net.deployable_params()["vf_w1"].shape == (6, 64)


@pytest.mark.parametrize("name", ["Env01-v2_PPO", "Env03-v2_r3a"])
def test_mlp_matches_jax(name):
    """policy_mean, value, log_prob of a checkpoint in float32; r3a has a
    privileged (14-input) critic."""
    d = checkpoint.load(MODELS / name / "best_model.npz")
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    net = mlp.from_numpy_params(d)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(32, 6)).astype(np.float32)
    vobs = rng.normal(size=(32, d["vf_w1"].shape[0])).astype(np.float32)
    act = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    with torch.no_grad():
        mean, log_std = net.policy_mean(torch.tensor(obs)), net.log_std.data
        value = net.value(torch.tensor(vobs))
        lp = net.log_prob(mean, torch.tensor(act))
    jmean = jmlp.policy_mean(jd, obs)
    np.testing.assert_allclose(mean, jmean, atol=1e-6)
    np.testing.assert_allclose(log_std, jd["log_std"], atol=0)
    # values and log-probs reach O(1e3): the same float32 bound, relative
    np.testing.assert_allclose(value, jmlp.value(jd, vobs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        lp, jmlp.log_prob(jmean, jd["log_std"], act), rtol=1e-6, atol=1e-6)
    ref = jmlp.deployable_params(jd, obs_dim=6)
    mine = net.deployable_params(obs_dim=6)
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    if d["vf_w1"].shape[0] == 6:
        with torch.no_grad():
            triple = net(torch.tensor(obs))
        for a, b in zip(triple, jmlp.forward(jd, obs)):
            np.testing.assert_allclose(a.detach(), b, rtol=1e-6, atol=1e-6)


def test_sample_draws_from_the_given_generator():
    net = mlp.from_numpy_params(checkpoint.load(POLICY))
    mean = torch.zeros(5, 2)
    a = net.sample(mean, torch.Generator().manual_seed(3))
    noise = torch.randn(5, 2, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, mean + net.log_std.exp().detach() * noise)


class StubEnv:
    """Episode i ends (terminated) after die_at[i] steps; reward at step k
    is k, so a return is 1 + 2 + ... + length."""
    max_episode_steps = 50
    dtype = torch.float64

    def __init__(self, die_at):
        self.die_at = torch.tensor(die_at)
        self.steps = 0

    def reset(self, n):
        return {"k": torch.zeros(n, dtype=torch.int64)}, torch.zeros(n, 6)

    def step(self, state, action):
        self.steps += 1
        k = state["k"] + 1
        obs = k[:, None].float().expand(-1, 6)
        return ({"k": k}, obs, k.to(torch.float64), k >= self.die_at,
                torch.zeros_like(k, dtype=torch.bool))


def test_evaluator_masks_done_envs_and_truncates():
    env = StubEnv([3, 7, 100, 100])
    seen = []

    def act(params, obs):
        seen.append(obs[:, 0].clone())
        return torch.zeros(obs.shape[0], 2)

    ev = ChunkedEvaluator(env, act, chunk=4)
    rets, lens = ev.evaluate_detail(None, 4, max_steps=10)
    assert lens.tolist() == [3, 7, 10, 10]
    assert rets.tolist() == [6.0, 28.0, 55.0, 55.0]
    # a done env's obs is frozen at its last value
    assert seen[-1].tolist() == [3.0, 7.0, 9.0, 9.0]
    # all done before the budget: the loop stops at the chunk boundary
    env2 = StubEnv([2, 3, 5, 6])
    rets2, lens2 = ChunkedEvaluator(env2, act, chunk=4).evaluate_detail(
        None, 4, max_steps=40)
    assert lens2.tolist() == [2, 3, 5, 6] and env2.steps == 8
    assert ev.evaluate(None, 4, max_steps=10) == (36.0, 7.5)


@functools.lru_cache(maxsize=None)
def _jax_control_step(params):
    # the JAX env's own physics (step.control_step), compiled once
    return jax.jit(lambda phys, ctrl, fric: jst.control_step(
        phys, ctrl, params, friction=fric))


def test_slice_env01_v2_deterministic_policy(x64):
    """The slice as a whole: Env01-v2 (fast solver), the checked-in policy
    acting deterministically, the same start states and noise draws, 5
    control steps, float64 throughout."""
    B, steps = 4, 5
    d = checkpoint.load(POLICY)
    jd = {k: jnp.asarray(v, jnp.float64) for k, v in d.items()}
    net = mlp.from_numpy_params(d, dtype=torch.float64)
    jenv = jbrt.make("Env01-v2").use_fast_solver()
    jenv._pallas_cs = _jax_control_step(jenv.params)
    env = brt.make("Env01-v2", device="cpu", dtype=torch.float64)
    env.use_fast_solver()

    rng = np.random.default_rng(11)
    qpos = np.zeros((B, 9))
    half = rng.uniform(-0.2, 0.2, B) / 2
    qpos[:, 3], qpos[:, 4] = np.cos(half), np.sin(half)
    qvel = rng.normal(size=(B, 8)) * 0.1
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js = jax.vmap(lambda q, v, k: jenv.state_from_qpos(q, v, key=k))(
        jnp.asarray(qpos), jnp.asarray(qvel), keys)
    ts = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel))

    def draws(key):
        _, k_r, k_t, k_o = jax.random.split(key, 4)
        k1, k2 = jax.random.split(k_o)
        return jnp.stack([jax.random.uniform(k) for k in (k_r, k_t, k1, k2)])

    jobs = jnp.zeros((B, 6))
    obs = torch.zeros(B, 6, dtype=torch.float64)
    jstep = jax.vmap(jenv.step)
    for _ in range(steps):
        u = torch.tensor(np.asarray(jax.vmap(draws)(js.key)))
        ja = jnp.clip(jmlp.policy_mean(jd, jobs.astype(jnp.float64)), -1, 1)
        with torch.no_grad():
            a = net.policy_mean(obs.double()).clamp(-1.0, 1.0)
        np.testing.assert_allclose(a, ja, atol=1e-8)
        js, jobs, jr, jterm, _ = jstep(js, ja)
        ts, obs, r, term, _ = env.step(ts, a, uniforms=u)
        np.testing.assert_allclose(r, jr, atol=1e-8)
        np.testing.assert_allclose(ts.phys.qpos,
                                   np.stack(js.phys.qpos, -1), atol=1e-8)
        # obs are float32 by contract: one ulp of their O(1) values
        np.testing.assert_allclose(obs, jobs, atol=1e-6)
        np.testing.assert_array_equal(term, jterm)
