"""The port's fatal-state harvest (`train/harvest.py`) against the JAX
package's, on the CPU.

Fresh episodes of a weak policy on Env03-v2 take about 60 control steps to
end on this host's plain physics (2.4 s per step at 8 envs) and none dies
after a respawned block there, so the bank would be empty. The tests start
the harvest instead from designed states (the `start` hook): robots
tipping over at several rates, with blocks parked far away whose respawn
delay (0.04 s, as in `tests/test_harvest.py`) runs out in the second
control step, so that some episodes die after a respawn launch (banked),
some before it (not banked), and every episode ends within the first
chunk.

  * the bank's invariants at `tests/test_harvest.py`'s sizes (8 episodes,
    a 200-step horizon, chunks of 50), the replay reset from a bank state,
    and the harvest's own resets from its seed;
  * the JAX function from the same start states (its env's reset returns
    them by key) and the same launch draws (recomputed from each state's
    key, with the splits of `envs/env03.py:163` and `:191`), 4 episodes of
    at most 12 steps in chunks of 6: the same counts and death times, the
    banked states to 1e-9 of each leaf's magnitude (float64 physics on the
    fast solver grade), the banked obs to 1e-6 (float32 by contract).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.envs import base as jbase
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.physics import block_step as jbs
from balance_robot_tpu.train.harvest import harvest_fatal_states as jharvest

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs.base import tree_map
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train.harvest import harvest_fatal_states

torch.set_num_threads(1)
F64 = torch.float64
DELAY = 0.04
START_T = 0             # the designed episodes start at t = 0


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def weak_policy():
    """A fresh PPO policy (the JAX package's init, as in
    tests/test_harvest.py): it acts near 0 and saves no robot."""
    p = jmlp.init_params(jax.random.PRNGKey(0), obs_dim=6, act_dim=2)
    return {k: np.asarray(v, np.float64) for k, v in p.items()}


def tilted(deg):
    half = math.radians(deg) / 2
    return [math.cos(half), math.sin(half), 0.0, 0.0]


# (pitch in degrees, pitch rate in rad/s, the respawn's step): kind 1 falls
# in the first step, before its block respawns; the others within 8 steps
# of their start, after it
KINDS = [(44.0, 3.0, 2), (49.0, 3.0, 2), (-44.0, -3.0, 2), (40.0, 3.0, 3)]


def designed(n, seed=5):
    """qpos (n, 16), qvel (n, 14), t (n,), aux of n episodes in the KINDS
    in turn, with small random differences."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((n, 16))
    qvel = np.zeros((n, 14))
    qpos[:, :2] = rng.uniform(-0.01, 0.01, (n, 2))
    qpos[:, 2] = -0.0205
    qpos[:, 7:9] = rng.uniform(-1, 1, (n, 2))
    qpos[:, 9:12] = [10.0, 10.0, 0.0]           # parked
    qpos[:, 12] = 1.0
    qvel[:, 6:8] = rng.uniform(-1, 1, (n, 2))
    t0 = np.zeros(n, np.float32)
    for i in range(n):
        pitch, rate, fire = KINDS[i % len(KINDS)]
        qpos[i, 3:7] = tilted(pitch + rng.uniform(-1, 1))
        qvel[i, 3] = rate
        # the delay runs out between the post-step times of steps fire - 1
        # and fire
        t0[i] = (START_T + fire - 0.5) * 0.005 - DELAY
    t = np.full(n, START_T, np.int32)
    aux = {"delay_started": np.ones(n, bool), "delay_t0": t0,
           "attack_front": np.arange(n) % 2 == 0}
    return qpos, qvel, t, aux


def port_env(horizon):
    env = brt.make("Env03-v2", device="cpu", dtype=F64).use_fast_solver()
    env.block_delay = DELAY
    env.max_episode_steps = horizon
    return env


def port_start(env, qpos, qvel, t, aux):
    s = env.state_from_arrays(qpos, qvel, np.zeros_like(qvel), t,
                              np.zeros(len(t)), np.zeros(len(t), np.float32),
                              np.zeros(len(t), bool), **aux)
    return env._obs(s, env._noise(len(t), 2))


def test_harvest_bank_and_replay_reset():
    """tests/test_harvest.py's sizes and checks, on designed starts: the
    bank holds the episodes that died after a respawn launch, each banked
    state is its launch step's snapshot (the block on its spawn circle),
    and a bank state restarts at t = 0 on a fresh generator."""
    env = port_env(200)
    start = port_start(env, *designed(8))
    params = weak_policy()
    bank, info = harvest_fatal_states(env, params, episodes=8, seed=3,
                                      chunk=50, start=start)
    assert info["episodes"] == 8
    assert info["full_rate"] == 0.0     # every episode ended in chunk 1
    # kind 1 falls before its block respawns: fatal, but not banked
    assert 4 <= info["n_bank"] == info["n_fatal"] <= 6
    n = info["n_bank"]
    assert (info["death_dt"] >= 0).all()
    for leaf in jax.tree.leaves(tuple(bank)):
        assert leaf.shape[0] == n
    assert info["obs"].shape == (n, 6)
    d = (bank.phys.qpos[:, 9:11] - bank.phys.qpos[:, :2]).norm(dim=-1)
    assert (d < 0.5).all(), d
    assert ((bank.t - START_T) >= 2).all()
    assert not bank.aux["delay_started"].any()

    fresh = brt.make("Env03-v2", device="cpu", dtype=F64,
                     seed=9).use_fast_solver()
    one = tree_map(lambda x: x[:1], bank)
    one = one._replace(t=torch.zeros_like(one.t))
    one, obs = fresh._obs(one, fresh._noise(1, 2))
    assert torch.isfinite(obs).all()
    net = mlp.from_numpy_params(params, dtype=F64)
    with torch.no_grad():
        _, obs2, r, _, _ = fresh.step(one, net.policy_mean(
            obs.to(F64)).clamp(-1, 1))
    assert torch.isfinite(obs2).all() and torch.isfinite(r).all()


def test_harvest_resets_from_its_seed():
    """Without a start, the episodes reset from a copy of the env with a
    generator seeded with `seed`: the same seed, the same harvest, and the
    env's own generator is left as it was."""
    env = port_env(2)
    g0 = env.generator.get_state()
    params = weak_policy()
    runs = [harvest_fatal_states(env, params, episodes=2, seed=s, chunk=2)
            for s in (4, 4, 5)]
    assert torch.equal(env.generator.get_state(), g0)
    (a, ia), (b, ib), (c, _) = runs
    assert ia["episodes"] == 2 and ia["n_bank"] == ib["n_bank"]
    assert not torch.equal(a.phys.qpos, c.phys.qpos) or ia["n_bank"] == 0
    for x, y in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b))):
        assert torch.equal(x, y)


# ------------------------------------------------------- against the JAX one

class StartsByKey:
    """The JAX env with `reset(key)` returning the designed state of that
    key (the JAX harvest resets from split(PRNGKey(seed), episodes))."""

    def __init__(self, env, keys, states, obs):
        self._env, self._keys = env, keys
        self._states, self._obs0 = states, obs

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, key):
        i = jnp.argmax(jnp.all(self._keys == key, axis=-1))
        return jax.tree.map(lambda x: x[i], self._states), self._obs0[i]


def jax_start(env, qpos, qvel, t, aux, keys):
    def one(qpos, qvel, t, aux, key):
        s = jbase.EnvState(
            phys=jbs.PhysState14(tuple(qpos), tuple(qvel),
                                 (jnp.zeros((), qpos.dtype),) * 14),
            t=t, last_pitch=jnp.zeros((), qpos.dtype),
            last_t=jnp.float32(0.0), has_last=jnp.asarray(False),
            target_wheel_speed=jnp.zeros((), qpos.dtype),
            target_yaw=jnp.zeros((), qpos.dtype), key=key, aux=aux)
        return env._obs(s)
    obs, states = jax.vmap(one)(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in aux.items()}, keys)
    return states, obs


def jax_launch_draws(keys, n_steps):
    """(n_steps, B, 6): the launch uniforms each JAX step draws, following
    each state's key through the env's splits (a done episode's draws are
    never used)."""
    def one(key):
        out = []
        for _ in range(n_steps):
            key = jax.random.split(key, 4)[0]            # step
            key, k_spawn = jax.random.split(key)         # _events
            out.append(jnp.stack([jax.random.uniform(k)
                                  for k in jax.random.split(k_spawn, 6)]))
        return jnp.stack(out)
    return torch.tensor(np.asarray(jax.vmap(one)(keys))).transpose(0, 1)


def test_harvest_matches_jax(x64):
    n, horizon, chunk, seed = 4, 12, 6, 3
    jenv = jbrt.make("Env03-v2").use_fast_solver()
    jenv._pallas_cs14 = jax.jit(lambda phys, ctrl: jbs.control_step14(
        phys, ctrl, jenv.params))
    jenv.block_delay = DELAY
    jenv.max_episode_steps = horizon
    qpos, qvel, t, aux = designed(n)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    js, jobs = jax_start(jenv, qpos, qvel, t, aux, keys)
    params = weak_policy()
    jbank, jinfo = jharvest(StartsByKey(jenv, keys, js, jobs), params,
                            episodes=n, seed=seed, chunk=chunk)

    env = port_env(horizon)
    start = (env.state_from_arrays(
        np.stack(js.phys.qpos, -1), np.stack(js.phys.qvel, -1),
        np.stack(js.phys.warmstart, -1), np.asarray(js.t),
        np.asarray(js.last_pitch), np.asarray(js.last_t),
        np.asarray(js.has_last), np.asarray(js.target_wheel_speed),
        np.asarray(js.target_yaw),
        **{k: np.asarray(v) for k, v in js.aux.items()}),
        torch.tensor(np.asarray(jobs)))
    bank, info = harvest_fatal_states(
        env, params, episodes=n, seed=seed, chunk=chunk, start=start,
        uniforms=jax_launch_draws(js.key, horizon))

    for k in ("episodes", "n_fatal", "n_bank", "full_rate"):
        assert info[k] == jinfo[k], k
    assert info["n_bank"] >= 2
    np.testing.assert_array_equal(info["death_dt"], np.asarray(
        jinfo["death_dt"]))
    np.testing.assert_allclose(info["obs"].numpy(), np.asarray(jinfo["obs"]),
                               rtol=0, atol=1e-6)
    pairs = {"qpos": (bank.phys.qpos, np.stack(jbank.phys.qpos, -1)),
             "qvel": (bank.phys.qvel, np.stack(jbank.phys.qvel, -1)),
             "warmstart": (bank.phys.warmstart,
                           np.stack(jbank.phys.warmstart, -1)),
             "last_pitch": (bank.last_pitch, jbank.last_pitch),
             "last_t": (bank.last_t, jbank.last_t)}
    for name, (mine, ref) in pairs.items():
        ref = np.asarray(ref, np.float64)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=1e-9 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    np.testing.assert_array_equal(bank.t.numpy(), np.asarray(jbank.t))
    for k, v in jbank.aux.items():
        np.testing.assert_allclose(bank.aux[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=k)
