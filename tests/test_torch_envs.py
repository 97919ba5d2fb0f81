"""The port's Env01 / Env02 envs and VecEnv against the JAX package (CPU).

Each env starts both packages from the same states (`state_from_qpos`, with
the same aux slots) and steps them with the same fixed actions; the port
takes the uniforms the JAX env draws, recomputed from the JAX state's key
with the splits of `envs/env01.py:135` and `:166`. float64 physics: the
states agree to rounding; obs are float32 by contract (both packages cast
them), so they agree to one float32 ulp of their O(1)-O(10) values.

Auto-reset draws from the port's own generator, so VecEnv is checked by
what it does, and the reset distribution by its ranges.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.envs import base as jbase
from balance_robot_tpu.physics import step as jst

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import base
from balance_robot_tpu_torch.envs.vector import VecEnv

torch.set_num_threads(1)
F64 = torch.float64
ENV_IDS = ["Env01-v1", "Env01-v2", "Env01-v3", "Env02-v1"]
B = 3
N_STEPS = 10


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _jax_control_step(params):
    # the JAX env's own physics (step.control_step), compiled once per scene
    return jax.jit(lambda phys, ctrl, fric: jst.control_step(
        phys, ctrl, params, friction=fric))


def jax_env(env_id):
    env = jbrt.make(env_id).use_fast_solver()
    env._pallas_cs = _jax_control_step(env.params)
    return env


def jax_uniforms(keys):
    """The 4 uniforms a JAX env step draws, per env: reward pitch noise,
    termination pitch noise, the two obs pitch reads."""
    def one(key):
        _, k_r, k_t, k_o = jax.random.split(key, 4)
        k1, k2 = jax.random.split(k_o)
        return jnp.stack([jax.random.uniform(k) for k in (k_r, k_t, k1, k2)])
    return torch.tensor(np.asarray(jax.vmap(one)(keys)), dtype=F64)


def start_states(seed, n):
    """Upright-ish starts: small tilts, wheel spin, some body motion."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((n, 9))
    qpos[:, :2] = rng.uniform(-0.01, 0.01, (n, 2))
    half = rng.uniform(-0.15, 0.15, n) / 2
    qpos[:, 3], qpos[:, 4] = np.cos(half), np.sin(half)
    qpos[:, 7:] = rng.uniform(-1, 1, (n, 2))
    qvel = rng.normal(size=(n, 8)) * np.array([.01, .01, .01, .2, .2, .2, 2,
                                               2])
    return qpos, qvel


def aux_for(env_id, n, seed):
    rng = np.random.default_rng(seed)
    if env_id == "Env01-v3":
        dts = rng.uniform(10, 20, n) * rng.choice([-1, 1], n)
        return {"delay_target_speed": dts,
                "pitch_offset": rng.uniform(-0.0349066, 0.0349066, n)}
    if env_id == "Env02-v1":
        return {"friction": rng.uniform(0.5, 1.0, n)}
    return {}


def actions_at(t, n):
    a = np.array([0.3 * np.sin(0.7 * t + 0.3), -0.2 * np.cos(0.5 * t)])
    return np.tile(a, (n, 1)).astype(np.float32) * np.linspace(
        0.5, 1.5, n, dtype=np.float32)[:, None]


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_env_trajectory_matches_jax(x64, env_id):
    qpos, qvel = start_states(0, B)
    aux = aux_for(env_id, B, 1)
    jenv = jax_env(env_id)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    js = jax.vmap(lambda q, v, k: jenv.state_from_qpos(q, v, key=k))(
        jnp.asarray(qpos), jnp.asarray(qvel), keys)
    js = js._replace(aux={k: jnp.asarray(v) for k, v in aux.items()})
    env = brt.make(env_id, device="cpu", dtype=F64).use_fast_solver()
    ts = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel),
                             aux={k: torch.tensor(v) for k, v in aux.items()})
    if env_id == "Env01-v3":
        # start just before the target-speed schedule's first switch (1 s)
        js = js._replace(t=jnp.full((B,), 195, jnp.int32))
        ts = ts._replace(t=torch.full((B,), 195, dtype=torch.int32))
    jstep = jax.vmap(jenv.step)
    for t in range(N_STEPS):
        a = actions_at(t, B)
        u = jax_uniforms(js.key)
        js, jobs, jr, jterm, jtrunc = jstep(js, jnp.asarray(a))
        ts, obs, r, term, trunc = env.step(ts, torch.tensor(a), uniforms=u)
        np.testing.assert_allclose(ts.phys.qpos, np.asarray(
            jnp.stack(js.phys.qpos, -1)), rtol=0, atol=1e-10)
        np.testing.assert_allclose(r, jr, rtol=0, atol=1e-8)
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-6)
        assert obs.dtype == torch.float32
        np.testing.assert_array_equal(term, jterm)
        np.testing.assert_array_equal(trunc, jtrunc)
        np.testing.assert_allclose(ts.last_pitch, js.last_pitch, atol=1e-10)
        np.testing.assert_allclose(ts.target_wheel_speed,
                                   js.target_wheel_speed, atol=1e-12)
    if env_id == "Env01-v3":
        assert (ts.target_wheel_speed != 0).all()


def tilted(pitch_deg):
    half = math.radians(pitch_deg) / 2
    return [0, 0, 0, math.cos(half), math.sin(half), 0, 0, 0, 0]


def test_vecenv_auto_reset():
    """Done envs get a fresh episode and the pre-reset obs is reported as
    terminal_obs; the others continue unchanged. Env 0 has fallen (55 deg),
    env 1 is one step from the horizon, env 2 balances."""
    env = brt.make("Env01-v2", device="cpu", dtype=F64).use_fast_solver()
    vec = VecEnv(env, 3)
    qpos = torch.tensor([tilted(55.0), tilted(2.0), tilted(-3.0)], dtype=F64)
    s = env.state_from_qpos(qpos)
    s = s._replace(t=torch.tensor([4, env.max_episode_steps - 1, 7],
                                  dtype=torch.int32))
    a = torch.zeros(3, 2)
    u = torch.rand(3, 4, dtype=F64, generator=torch.Generator().manual_seed(0))
    ref_state, ref_obs, ref_r, ref_term, ref_trunc = env.step(s, a, u)
    s2, out = vec.step(s, a, uniforms=u)

    assert out.terminated.tolist() == [True, False, False]
    assert out.truncated.tolist() == [False, True, False]
    assert out.done.tolist() == [True, True, False]
    torch.testing.assert_close(out.terminal_obs, ref_obs, rtol=0, atol=0)
    torch.testing.assert_close(out.reward, ref_r, rtol=0, atol=0)
    assert out.terminal_priv.shape == (3, 0)
    # the env that continues is untouched by the reset
    torch.testing.assert_close(out.obs[2], ref_obs[2], rtol=0, atol=0)
    base.tree_map(lambda x, y: torch.testing.assert_close(
        x[2], y[2], rtol=0, atol=0), s2, ref_state)
    # the done envs start fresh episodes, fd pitch_dot re-anchored at t = 0
    done = out.done
    assert s2.t[done].tolist() == [0, 0]
    assert (s2.last_t[done] == 0).all() and s2.has_last[done].all()
    noise = (s2.last_pitch - base.pitch_of(s2.phys.qpos))[done]
    assert (noise.abs() <= 0.025 + 1e-12).all()
    assert (out.obs[done, 1] == 0).all()          # no previous obs yet
    assert (s2.phys.qvel[done] == 0).all()
    assert (s2.phys.qpos[done, 2] == 0).all()
    assert not torch.equal(out.obs[done], ref_obs[done])
    # the next step continues the new episodes from t = 0
    s3, _ = vec.step(s2, a)
    assert s3.t.tolist() == [1, 1, 9]


@pytest.mark.parametrize("env_id", ["Env01-v1", "Env01-v2"])
def test_reset_distribution(env_id):
    """qpos noise in +-0.01 (z = 0), zero velocity, and the reference's
    scrambled quaternion: scipy's [x, y, z, w] written into [w, x, y, z],
    whose euler angles span the reset ranges."""
    from scipy.spatial.transform import Rotation
    env = brt.make(env_id, device="cpu", dtype=F64, seed=3)
    s, obs = env.reset(1000)
    qpos = s.phys.qpos.numpy()
    assert np.abs(qpos[:, [0, 1, 7, 8]]).max() <= 0.01
    assert (qpos[:, 2] == 0).all() and (s.phys.qvel == 0).all()
    assert obs.shape == (1000, 6) and obs.dtype == torch.float32
    assert (s.t == 0).all() and s.has_last.all()
    np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7], axis=1), 1.0,
                               atol=1e-12)
    # the slots hold scipy's [x, y, z, w] order verbatim
    euler = Rotation.from_quat(qpos[:, 3:7]).as_euler("xyz")
    ranges = (math.pi, env.reset_y_range, env.reset_z_range)
    for k, r in enumerate(ranges):
        assert np.abs(euler[:, k]).max() <= r + 1e-9
        assert np.abs(euler[:, k]).max() > 0.95 * r
        assert abs(euler[:, k].mean()) < 0.1 * r


def test_scrambled_quaternion_and_pitch_match_jax(x64):
    rng = np.random.default_rng(5)
    x, y, z = (rng.uniform(-3, 3, 64) for _ in range(3))
    ref = jax.vmap(jbase.scipy_euler_to_mj_quat_scrambled)(x, y, z)
    mine = base.scipy_euler_to_mj_quat_scrambled(
        *(torch.tensor(v) for v in (x, y, z)))
    np.testing.assert_allclose(mine, np.stack(ref, -1), atol=1e-15)
    qpos = rng.normal(size=(64, 9))
    qpos[:4, 3] = 0.0                  # the qpos[3] == 0 guard
    ref_pitch = jax.vmap(lambda q: jbase.pitch_of(tuple(q)))(qpos)
    np.testing.assert_allclose(base.pitch_of(torch.tensor(qpos)), ref_pitch,
                               atol=1e-14)
    assert (base.pitch_of(torch.tensor(qpos))[:4] == 0).all()
