"""The port's Env03 envs, VecEnv and PrivilegedObsEnv against the JAX package
(CPU).

Each env starts both packages from the same state: the JAX `EnvState` is
built here with a `PhysState14`, and its arrays go through the port's
`state_from_arrays`. Both step with the same fixed actions; the port takes
the launch draws the JAX env makes, recomputed from the JAX state's key
with the splits of `envs/env03.py:191`, `:163` and `:136`. The start states
are set so that a few control steps include a park, a respawn, an impact
and (v1-fail) a fall. float64 physics on the fast solver grade: the states
agree to rounding (1e-10 after a few control steps); obs and privileged
features are float32 by contract, so they agree to one float32 ulp of their
O(1)-O(10) values.

Resets draw from the port's own generator, so VecEnv is checked by what it
does, and the reset and launch distributions by their ranges.
"""

import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.envs import base as jbase
from balance_robot_tpu.envs.privileged import PrivilegedObsEnv as JPrivEnv
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.physics import block_step as jbs

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import base
from balance_robot_tpu_torch.envs.privileged import PrivilegedObsEnv
from balance_robot_tpu_torch.envs.vector import VecEnv
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint

torch.set_num_threads(1)
F64 = torch.float64
B = 3
N_STEPS = 4
MODELS = Path(__file__).resolve().parents[1] / "models"


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _jax_control_step14(params):
    # the JAX env's own physics (block_step.control_step14), compiled once
    # for all three envs: they share ENV03_PARAMS
    return jax.jit(lambda phys, ctrl: jbs.control_step14(phys, ctrl, params))


def jax_env(env_id):
    env = jbrt.make(env_id).use_fast_solver()
    env._pallas_cs14 = _jax_control_step14(env.params)
    return env


def jax_uniforms(keys):
    """The 6 uniforms a JAX Env03 step's launch draws, per env."""
    def one(key):
        key = jax.random.split(key, 4)[0]            # step
        k_spawn = jax.random.split(key)[1]           # _events
        return jnp.stack([jax.random.uniform(k)
                          for k in jax.random.split(k_spawn, 6)])
    return torch.tensor(np.asarray(jax.vmap(one)(keys)), dtype=F64)


def tilted(pitch_deg):
    half = math.radians(pitch_deg) / 2
    return [math.cos(half), math.sin(half), 0.0, 0.0]


def start(env_id):
    """qpos (B,16), qvel (B,14), t (B,), aux. Env 0: a slow block on the
    floor (parks in step 1); env 1: a block 2 cm from the chassis at 5 m/s
    (impact in step 1); env 2: a parked block whose delay runs out (fires
    in step 2, or step 1 where the delay is 0)."""
    rng = np.random.default_rng(11)
    qpos = np.zeros((B, 16))
    qpos[:, :2] = rng.uniform(-0.01, 0.01, (B, 2))
    qpos[:, 2] = -0.0205
    qpos[:, 3:7] = [tilted(3.0), tilted(-2.0), tilted(1.0)]
    qpos[:, 7:9] = rng.uniform(-1, 1, (B, 2))
    qb = rng.normal(size=(B, 4))
    qpos[:, 12:16] = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    qvel = rng.normal(size=(B, 14)) * np.array(
        [.01, .01, .01, .2, .2, .2, 2, 2, 0, 0, 0, 1, 1, 1])
    qpos[0, 9:16] = [0.4, 0.3, 0.0005, 1, 0, 0, 0]
    qvel[0, 8:14] = [0.04, 0.02, 0.0, 0, 0, 0]
    qpos[1, 9:12] = [qpos[1, 0], qpos[1, 1] + 0.06, 0.12]
    qvel[1, 8:11] = [0.0, -5.0, 0.0]
    qpos[2, 9:12] = [10.0, 10.0, 0.0]
    qvel[2, 8:11] = [0.02, 0.0, 0.0]
    t = np.array([150, 150, 150], np.int32)
    aux = {"delay_started": np.array([False, False, True]),
           "delay_t0": np.array([0.0, 0.0, 0.2575], np.float32)}
    if env_id == "Env03-v2":
        aux["attack_front"] = np.array([True, False, False])
    if env_id == "Env03-v1-fail":
        # env 1 is falling: 49 deg and tipping, past 50 deg within a step
        qpos[1, 3:7] = tilted(49.0)
        qvel[1, 3] = 3.0
        aux["fallen"] = np.array([False, False, False])
    return qpos, qvel, t, aux


def jax_state(qpos, qvel, t, aux, keys):
    def one(qpos, qvel, t, aux, key):
        return jbase.EnvState(
            phys=jbs.PhysState14(tuple(qpos), tuple(qvel),
                                 (jnp.zeros((), qpos.dtype),) * 14),
            t=t, last_pitch=jbase.pitch_of(tuple(qpos)),
            last_t=jnp.float32(0.0), has_last=jnp.asarray(True),
            target_wheel_speed=jnp.float32(0.0), target_yaw=jnp.float32(0.0),
            key=key, aux=aux)
    return jax.vmap(one)(jnp.asarray(qpos), jnp.asarray(qvel),
                         jnp.asarray(t),
                         {k: jnp.asarray(v) for k, v in aux.items()}, keys)


def port_state(env, js):
    """The JAX EnvState's arrays through the port's state_from_arrays."""
    return env.state_from_arrays(
        np.stack(js.phys.qpos, -1), np.stack(js.phys.qvel, -1),
        np.stack(js.phys.warmstart, -1), np.asarray(js.t),
        np.asarray(js.last_pitch), np.asarray(js.last_t),
        np.asarray(js.has_last), np.asarray(js.target_wheel_speed),
        np.asarray(js.target_yaw),
        **{k: np.asarray(v) for k, v in js.aux.items()})


def actions_at(t, n):
    a = np.array([0.3 * np.sin(0.7 * t + 0.3), -0.2 * np.cos(0.5 * t)])
    return np.tile(a, (n, 1)).astype(np.float32) * np.linspace(
        0.5, 1.5, n, dtype=np.float32)[:, None]


@pytest.mark.parametrize("env_id", ["Env03-v1", "Env03-v2", "Env03-v1-fail"])
def test_env03_trajectory_matches_jax(x64, env_id):
    qpos, qvel, t0, aux = start(env_id)
    jenv = jax_env(env_id)
    env = brt.make(env_id, device="cpu", dtype=F64).use_fast_solver()
    if env_id == "Env03-v2":
        # the teacher's view on both sides: obs = [obs, privileged(state)]
        jenv, env = JPrivEnv(jenv), PrivilegedObsEnv(env)
        assert env.obs_dim == jenv.obs_dim == 14
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    js = jax_state(qpos, qvel, t0, aux, keys)
    ts = port_state(env, js)
    jstep = jax.vmap(jenv.step)
    jpriv = jax.vmap(jenv.privileged)
    parked, fired, fallen = [], [], []
    for t in range(N_STEPS):
        a = actions_at(t, B)
        u = jax_uniforms(js.key)
        started_before = np.asarray(js.aux["delay_started"])
        js, jobs, jr, jterm, jtrunc = jstep(js, jnp.asarray(a))
        ts, obs, r, term, trunc = env.step(ts, torch.tensor(a), uniforms=u)
        np.testing.assert_allclose(ts.phys.qpos, np.stack(js.phys.qpos, -1),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(ts.phys.qvel, np.stack(js.phys.qvel, -1),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(r, jr, rtol=0, atol=1e-8)
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-6)
        assert obs.dtype == torch.float32
        np.testing.assert_array_equal(term, jterm)
        np.testing.assert_array_equal(trunc, jtrunc)
        np.testing.assert_allclose(ts.last_pitch, js.last_pitch, atol=1e-10)
        for name, ref in js.aux.items():
            np.testing.assert_array_equal(ts.aux[name], np.asarray(ref),
                                          err_msg=name)
            assert ts.aux[name].dtype == (torch.float32 if name == "delay_t0"
                                          else torch.bool)
        priv = env.privileged(ts)
        assert priv.dtype == torch.float32 and priv.shape == (B, 8)
        np.testing.assert_allclose(priv, jpriv(js), rtol=0, atol=1e-6)
        started = np.asarray(js.aux["delay_started"])
        parked.append(started & ~started_before)
        fired.append(started_before & ~started)
        fallen.append(np.asarray(jterm))
    # the run went through the events it was set up for
    assert parked[0][0]                                 # the slow block
    assert np.stack(fired)[:, 2].any()                  # the parked block
    if env.block_delay == 0.0:
        assert np.stack(fired)[:, 0].any()              # park, then respawn
        assert (ts.phys.qpos[0, 9:11] != 10.0).all()
    else:
        # still waiting at the park position (it slides on at < 0.1 m/s)
        assert ((ts.phys.qpos[0, 9:11] - 10.0).abs() < 1e-2).all()
    if env_id == "Env03-v1-fail":
        assert np.stack(fallen)[:, 1].any() and ts.aux["fallen"][1]
        assert not ts.aux["fallen"][0]
    if env_id == "Env03-v2":
        # front attacks come from -yaw, back attacks from the other side
        hint = np.asarray(jpriv(js))[:, 7]
        np.testing.assert_array_equal(hint, [1.0, -1.0, -1.0])


def test_vecenv_keeps_the_attack_side_and_reports_terminal_priv():
    """Env 0 has fallen (55 deg), env 1 is one step from the horizon, env 2
    balances: the done envs start fresh episodes with a block in the air,
    but keep their attack side; terminal_priv is the pre-reset state's."""
    env = brt.make("Env03-v2", device="cpu", dtype=F64).use_fast_solver()
    vec = VecEnv(env, 3, with_priv=True)
    assert vec.priv_dim == 8 and VecEnv(env, 3).priv_dim == 0
    qpos, qvel, _, aux = start("Env03-v2")
    qpos[0, 3:7] = tilted(55.0)
    s = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel), aux=aux)
    s = s._replace(t=torch.tensor([4, env.max_episode_steps - 1, 7],
                                  dtype=torch.int32))
    a = torch.zeros(3, 2)
    u = torch.rand(3, 6, dtype=F64, generator=torch.Generator().manual_seed(0))
    ref_state, ref_obs, _, _, _ = env.step(s, a, u)
    s2, out = vec.step(s, a, uniforms=u)
    assert out.terminated.tolist() == [True, False, False]
    assert out.truncated.tolist() == [False, True, False]
    torch.testing.assert_close(out.terminal_obs, ref_obs, rtol=0, atol=0)
    torch.testing.assert_close(out.terminal_priv, env.privileged(ref_state),
                               rtol=0, atol=0)
    assert out.terminal_priv.shape == (3, 8)
    assert s2.aux["attack_front"].tolist() == [True, False, False]
    base.tree_map(lambda x, y: torch.testing.assert_close(
        x[2], y[2], rtol=0, atol=0), s2, ref_state)
    done = out.done
    assert s2.t[done].tolist() == [0, 0]
    assert not s2.aux["delay_started"][done].any()
    rel = (s2.phys.qpos[:, 9:11] - s2.phys.qpos[:, 0:2])[done]
    torch.testing.assert_close(rel.norm(dim=1), torch.full((2,), 0.3,
                                                           dtype=F64))
    # the new block comes from the side the env instance attacks from
    yaw = base.yaw_of(s2.phys.qpos)[done]
    front = torch.stack((torch.sin(-yaw), torch.cos(-yaw)), -1) * 0.3
    sign = torch.tensor([1.0, -1.0], dtype=F64).unsqueeze(-1)
    torch.testing.assert_close(rel, front * sign)
    # without with_priv the features are not computed
    _, out0 = VecEnv(env, 3).step(s, a, uniforms=u)
    assert out0.terminal_priv.shape == (3, 0)


@pytest.mark.parametrize("env_id", ["Env03-v1", "Env03-v2"])
def test_reset_and_launch_distributions(env_id):
    """Reset: qpos noise in +-0.01 (z = 0), zero robot velocity, and a
    block already in the air: on the 0.3 m circle around the robot at
    z = 0.15, flying at 5 (v1) or 7.5 (v2) m/s at an aim point above the
    robot; v1 from any direction, v2 from -yaw or the opposite side."""
    env = brt.make(env_id, device="cpu", dtype=F64, seed=5)
    n = 2000
    s, obs = env.reset(n)
    qpos, qvel = s.phys.qpos.numpy(), s.phys.qvel.numpy()
    assert obs.shape == (n, 6) and obs.dtype == torch.float32
    assert np.abs(qpos[:, [0, 1, 7, 8]]).max() <= 0.01
    assert (qpos[:, 2] == 0).all()
    assert (qvel[:, :8] == 0).all() and (qvel[:, 11:] == 0).all()
    assert not s.aux["delay_started"].any() and (s.t == 0).all()
    rel = qpos[:, 9:11] - qpos[:, 0:2]
    np.testing.assert_allclose(np.hypot(rel[:, 0], rel[:, 1]), 0.3,
                               atol=1e-12)
    np.testing.assert_allclose(qpos[:, 11], np.float32(0.15), atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(qvel[:, 8:11], axis=1),
                               env.block_speed, rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(qpos[:, 12:16], axis=1), 1.0,
                               atol=1e-12)
    # the aim point: where the block's line of flight crosses the robot's y
    jx, zlo, zrange = env._target_jitter()
    tt = -rel[:, 1] / qvel[:, 9]
    ok = np.abs(qvel[:, 9]) > 1.0
    aim_x = (rel[:, 0] + tt * qvel[:, 8])[ok]
    aim_z = (qpos[:, 11] + tt * qvel[:, 10])[ok]
    assert np.abs(aim_x).max() <= jx + 1e-9
    assert aim_z.min() >= zlo - 1e-9 and aim_z.max() <= zlo + zrange + 1e-9
    assert aim_z.max() - aim_z.min() > 0.9 * zrange
    angle = np.arctan2(rel[:, 0], rel[:, 1])        # bx = sin, by = cos
    if env_id == "Env03-v1":
        assert "attack_front" not in s.aux
        hist, _ = np.histogram(angle, bins=8, range=(-np.pi, np.pi))
        assert hist.min() > 0.6 * n / 8
    else:
        front = s.aux["attack_front"].numpy()
        assert 0.4 < front.mean() < 0.6
        yaw = base.yaw_of(s.phys.qpos).numpy()
        want = np.where(front, -yaw, -yaw + np.pi)
        d = np.angle(np.exp(1j * (angle - want)))
        np.testing.assert_allclose(d, 0.0, atol=1e-9)
        hint = env.privileged(s)[:, 7].numpy()
        np.testing.assert_array_equal(hint, np.where(front, 1.0, -1.0))


def test_privileged_wrapper_needs_privileged_features():
    with pytest.raises(ValueError, match="privileged"):
        PrivilegedObsEnv(brt.make("Env01-v2", device="cpu"))
    env = PrivilegedObsEnv(brt.make("Env03-v1", device="cpu"))
    s, obs = env.reset(4)
    assert obs.shape == (4, 14) and obs.dtype == torch.float32
    torch.testing.assert_close(obs[:, 6:], env.privileged(s), rtol=0, atol=0)
    assert env.id == "Env03-v1" and env.max_episode_steps == 6000


def test_registry_lists_the_env03_ids():
    assert {"Env03-v1", "Env03-v2", "Env03-v1-fail"} <= set(brt.env_ids())
    for env_id in ("Env03-v1", "Env03-v2", "Env03-v1-fail"):
        env, jenv = brt.make(env_id, device="cpu"), jbrt.make(env_id)
        for name in ("max_episode_steps", "block_delay", "block_speed",
                     "priv_dim", "obs_dim", "act_dim"):
            assert getattr(env, name) == getattr(jenv, name), (env_id, name)


def test_flagship_policy_matches_jax():
    """models/Env03-v2_r2i gives the same policy_mean in both packages on
    the same obs (float32 on both sides, summed in another order)."""
    d = checkpoint.load(MODELS / "Env03-v2_r2i" / "best_model.npz")
    net = mlp.from_numpy_params(d)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, 6)).astype(np.float32) * 2
    with torch.no_grad():
        mean = net.policy_mean(torch.tensor(obs))
    jmean = jmlp.policy_mean({k: jnp.asarray(v) for k, v in d.items()}, obs)
    np.testing.assert_allclose(mean, jmean, atol=1e-6)
    assert np.abs(np.asarray(jmean)).max() > 0.1
