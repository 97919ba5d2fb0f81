"""The burst ratchet's training envs (`envs/hardened.py`) against the JAX
tool's patches of its training env (`tools/burst_refine.py:129-240`), on
the CPU.

The JAX side is built here as the tool builds it: `_reward` patched to
return 1.0, `_init_aux` patched to draw `attack_front = u > back_frac`
from the slot's key, and the failure-replay reset written out as the
tool's `_replay_reset` (a bank leaf with t = 0 and last_t = 0, the banked
obs). Both packages start from the same states (the JAX `EnvState` built
with a `PhysState14`, its arrays through the port's `state_from_arrays`)
and take the same launch draws (recomputed from the JAX state's key, with
the splits of `envs/env03.py:191` and `:163`), float64 physics on the fast
solver grade, B <= 4 and one control step each, so the file stays light.
"""

import functools
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.envs import base as jbase
from balance_robot_tpu.physics import block_step as jbs

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import base
from balance_robot_tpu_torch.envs.hardened import ReplayResetEnv, harden
from balance_robot_tpu_torch.envs.vector import VecEnv

torch.set_num_threads(1)
F64 = torch.float64
B = 3


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _jax_control_step14(params):
    return jax.jit(lambda phys, ctrl: jbs.control_step14(phys, ctrl, params))


def jax_env(block_delay=None):
    env = jbrt.make("Env03-v2").use_fast_solver()
    env._pallas_cs14 = _jax_control_step14(env.params)
    if block_delay is not None:
        env.block_delay = block_delay
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


def start():
    """qpos (B,16), qvel (B,14), t (B,), aux of three Env03-v2 states: a
    slow block on the floor, a block 2 cm from the chassis at 5 m/s (an
    impact in the step), a parked block whose delay runs out."""
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
           "delay_t0": np.array([0.0, 0.0, 0.2575], np.float32),
           "attack_front": np.array([True, False, False])}
    return qpos, qvel, t, aux


def jax_state(keys):
    qpos, qvel, t, aux = start()

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


def actions(n):
    return np.tile([[0.3, -0.2]], (n, 1)) * np.linspace(0.5, 1.5, n)[:, None]


def assert_same_state(ps, js, atol):
    np.testing.assert_allclose(ps.phys.qpos, np.stack(js.phys.qpos, -1),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(ps.phys.qvel, np.stack(js.phys.qvel, -1),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(ps.t, js.t)
    np.testing.assert_allclose(ps.last_pitch, js.last_pitch, rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(ps.last_t, js.last_t)
    np.testing.assert_array_equal(ps.has_last, js.has_last)
    for name, ref in js.aux.items():
        np.testing.assert_array_equal(ps.aux[name], np.asarray(ref),
                                      err_msg=name)


# ------------------------------------------------------------- hardening

def test_survival_reward_step_matches_the_jax_tools_patch(x64):
    """The tool's `_reward` patch on the JAX env and `harden(...,
    survival_reward=True)` (with the tool's block_delay override) step the
    same states alike; the reward is exactly 1 and the step still makes its
    launch draws."""
    jenv = jax_env(block_delay=0.2)
    jenv._reward = types.MethodType(lambda self, s, k: jnp.float32(1.0),
                                    jenv)
    plain = brt.make("Env03-v2", device="cpu", dtype=F64,
                     seed=3).use_fast_solver()
    env = harden(plain, block_delay=0.2, survival_reward=True)
    assert env.block_delay == 0.2 and plain.block_delay == 0.5
    assert env.id == "Env03-v2" and isinstance(env, type(plain))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    js = jax_state(keys)
    ps = port_state(env, js)
    a = actions(B)
    u = jax_uniforms(js.key)
    js2, jobs, jr, jterm, jtrunc = jax.vmap(jenv.step)(js, jnp.asarray(a))
    twin = torch.Generator()
    twin.set_state(env.generator.get_state())
    ps2, obs, r, term, trunc = env.step(ps, torch.tensor(a))
    # the launch draws of the survival step are the plain env's
    torch.rand((B, 6), generator=twin, dtype=F64)
    assert torch.equal(env.generator.get_state(), twin.get_state())
    ps2, obs, r, term, trunc = env.step(ps, torch.tensor(a), uniforms=u)
    assert r.dtype == F64 and torch.equal(r, torch.ones(B, dtype=F64))
    np.testing.assert_array_equal(np.asarray(jr), 1.0)
    assert_same_state(ps2, js2, 1e-9)
    np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(term, jterm)
    np.testing.assert_array_equal(trunc, jtrunc)
    # the impact of env 1 happened, so the comparison covered the block
    assert (ps2.phys.qvel[1, 8:11] - ps.phys.qvel[1, 8:11]).abs().max() > 0.1


@pytest.mark.parametrize("back_frac", [0.7, 0.2])
def test_back_frac_decides_the_side_from_the_slots_uniform(monkeypatch,
                                                            back_frac):
    """attack_front = u > back_frac: on the JAX tool's `_init_aux` patch
    from each slot's key, on the port's `_init_aux` with the same uniforms
    injected, and within a reset at the place of Env03-v2's own side
    draw."""
    jenv = jbrt.make("Env03-v2")
    orig = type(jenv)._init_aux

    def biased(self, key):                  # the tool's patch, verbatim
        aux = orig(self, key)
        aux["attack_front"] = jax.random.uniform(key) > back_frac
        return aux

    jenv._init_aux = types.MethodType(biased, jenv)
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    jfront = np.asarray(jax.vmap(lambda k: jenv._init_aux(k)[
        "attack_front"])(keys))
    u = np.asarray(jax.vmap(jax.random.uniform)(keys))
    np.testing.assert_array_equal(jfront, u > back_frac)

    env = harden(brt.make("Env03-v2", device="cpu", dtype=F64),
                 back_frac=back_frac)
    monkeypatch.setattr(env, "_uniform",
                        lambda *shape: torch.tensor(u, dtype=F64))
    np.testing.assert_array_equal(env._init_aux(64)["attack_front"], jfront)

    env = harden(brt.make("Env03-v2", device="cpu", dtype=F64, seed=9),
                 back_frac=back_frac)
    s, _ = env.reset(2000)
    twin = torch.Generator().manual_seed(9)
    torch.rand((2000, 19), generator=twin, dtype=F64)      # qpos, euler
    side = torch.rand(2000, generator=twin, dtype=F64)
    assert torch.equal(s.aux["attack_front"], side > back_frac)
    share = s.aux["attack_front"].double().mean().item()
    assert abs(share - (1 - back_frac)) < 3 * math.sqrt(
        back_frac * (1 - back_frac) / 2000)
    with pytest.raises(ValueError, match="attack side"):
        harden(brt.make("Env03-v1", device="cpu"), back_frac=0.7)


# ---------------------------------------------------------------- replay

def jax_replay_reset(env, bank, bank_obs, frac):
    """The tool's `_replay_reset` (burst_refine.py:205-222), verbatim but
    for returning the bank index."""
    n_bank = bank.t.shape[0]
    orig_reset = env.reset

    def reset(key):
        k1, k2, k3 = jax.random.split(key, 3)
        state0, obs0 = orig_reset(k1)
        i = jax.random.randint(k3, (), 0, n_bank)
        bs = jax.tree.map(lambda x: x[i], bank)
        bs = bs._replace(key=k1, t=jnp.int32(0), last_t=jnp.float32(0.0))
        use = jax.random.uniform(k2) < frac
        state = jax.tree.map(lambda a, b: jnp.where(use, a, b), bs, state0)
        state = state._replace(aux={**state.aux, "replayed": use})
        obs = jnp.where(use, bank_obs[i], obs0)
        return state, obs, i, use
    return reset


def bank_obs_rows(n):
    rng = np.random.default_rng(4)
    return rng.normal(size=(n, 6)).astype(np.float32)


def test_replay_reset_and_step_match_the_jax_tool(x64):
    """frac = 1: every row takes its bank state at t = 0 with the banked
    obs, as the tool builds it; one Env03-v2 step from there agrees in
    qpos, qvel, obs and reward."""
    n = B                           # the compiled step's batch
    jenv = jax_env()
    jbank = jax_state(jax.random.split(jax.random.PRNGKey(7), B))
    obs_np = bank_obs_rows(B)
    keys = jax.random.split(jax.random.PRNGKey(21), n)
    js, jobs, idx, use = jax.vmap(jax_replay_reset(
        jenv, jbank, jnp.asarray(obs_np), 1.0))(keys)
    assert np.asarray(use).all() and len(set(np.asarray(idx))) > 1

    env = brt.make("Env03-v2", device="cpu", dtype=F64).use_fast_solver()
    wrap = ReplayResetEnv(env, port_state(env, jbank),
                          torch.tensor(obs_np), 1.0)
    idx = torch.tensor(np.array(idx))
    ps, obs = wrap.reset(n, draws=(idx, torch.ones(n, dtype=torch.bool)))
    assert_same_state(ps, js, 0.0)
    assert torch.equal(obs, torch.tensor(obs_np)[idx])
    np.testing.assert_array_equal(obs, jobs)
    assert ps.t.dtype == torch.int32 and ps.last_t.dtype == torch.float32
    assert (wrap.resets, int(wrap.replayed)) == (n, n)

    a = actions(n)
    u = jax_uniforms(js.key)
    js2, jobs2, jr, jterm, _ = jax.vmap(jenv.step)(js, jnp.asarray(a))
    ps2, obs2, r, term, _ = wrap.step(ps, torch.tensor(a), uniforms=u)
    assert_same_state(ps2, js2, 1e-9)
    np.testing.assert_allclose(obs2, jobs2, rtol=0, atol=1e-9)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(term, jterm)
    assert ps2.aux["replayed"].all()


def port_bank():
    """The three states of `start` as a bank (last_t 0.75 s: the replay
    resets it), built on an env of its own (building draws the side)."""
    env = brt.make("Env03-v2", device="cpu", dtype=F64)
    qpos, qvel, t, aux = start()
    return env.state_from_arrays(qpos, qvel, np.zeros((B, 14)), t,
                                 env.state_from_qpos(torch.tensor(
                                     qpos)).last_pitch,
                                 np.full(B, 0.75, np.float32),
                                 np.ones(B, bool), **aux)


def test_replay_at_frac_0_is_the_plain_reset_bit_for_bit():
    env = brt.make("Env03-v2", device="cpu", dtype=F64, seed=5)
    wrap = ReplayResetEnv(env, port_bank(),
                          torch.tensor(bank_obs_rows(B)), 0.0)
    s, obs = wrap.reset(16)
    s0, obs0 = brt.make("Env03-v2", device="cpu", dtype=F64,
                        seed=5).reset(16)
    assert not s.aux.pop("replayed").any()
    base.tree_map(lambda x, y: torch.testing.assert_close(
        x, y, rtol=0, atol=0), s, s0)
    assert torch.equal(obs, obs0)
    assert (wrap.resets, int(wrap.replayed)) == (16, 0)
    with pytest.raises(ValueError, match="empty"):
        ReplayResetEnv(env, base.tree_map(lambda x: x[:0], port_bank()),
                       torch.zeros(0, 6), 0.25)


def test_carry_keeps_a_replayed_rows_side_and_vecenv_mixes_rows():
    """A slot's side carries over its plain resets; a replayed row keeps
    its bank state's side. One VecEnv step over replayed and plain rows,
    one of them done: the done row takes its reset candidate with the
    carry rule, the others keep their state and their replayed flag."""
    env = brt.make("Env03-v2", device="cpu", dtype=F64,
                   seed=2).use_fast_solver()
    bank = port_bank()                       # sides T, F, F
    wrap = ReplayResetEnv(env, bank, torch.tensor(bank_obs_rows(B)), 0.5)
    idx = torch.tensor([0, 1, 0, 2])
    use = torch.tensor([True, False, True, False])
    new, obs = wrap.reset(4, draws=(idx, use))
    assert torch.equal(new.aux["replayed"], use)
    assert torch.equal(new.t, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(new.phys.qpos[use], bank.phys.qpos[idx[use]])
    assert torch.equal(new.last_pitch[use], bank.last_pitch[idx[use]])
    old = new._replace(aux={**new.aux, "attack_front": torch.tensor(
        [False, True, False, True])})
    carried = wrap.carry_across_reset(old, new)
    assert carried.aux["attack_front"].tolist() == [True, True, True, True]

    vec = VecEnv(wrap, 4)
    # env 3 (plain, attacked from the back) reaches the horizon in the step
    state = new._replace(t=torch.tensor([0, 3, 0, env.max_episode_steps - 1],
                                        dtype=torch.int32),
                         aux={**new.aux, "attack_front": torch.tensor(
                             [True, True, False, False])})
    s2, out = vec.step(state, torch.zeros(4, 2))
    assert out.done.tolist() == [False, False, False, True]
    assert s2.t.tolist() == [1, 4, 1, 0]
    assert s2.aux["replayed"][:3].tolist() == [True, False, True]
    assert s2.aux["attack_front"][:3].tolist() == [True, True, False]
    # the done slot's new episode keeps the slot's side unless replayed
    if not s2.aux["replayed"][3]:
        assert not s2.aux["attack_front"][3]
    assert all(torch.isfinite(t).all() for t in s2.phys)
    assert wrap.resets == 8
