"""The port's Env03-v1 step held to the benchmark's plain reference
(`perf_bench/reference/envs/Env03-v1.py`) on the CPU in float64 at B = 8,
over 3 control steps of the plain 14-dof physics at the fast grade, from
states with the block in flight at the robot's front, back and two sides,
pressed against a wheel, against a chassis side face, resting on the floor
slower than 0.1 m/s (parked at the first step, fired at the second) and
already parked (fired at the first step).

Tolerances, each with its reason:
  * the states (qpos, qvel; the warm start relative to its scale), the
    reward and the fd-pitch slots agree within 1e-9 after 3 steps: both
    sides run the same float64 arithmetic of the same equations, and the
    reference is a frozen copy that a later change of the port's summation
    order may only move by rounding, which stays far below 1e-9 over 3
    steps (it reads 0 today);
  * the obs is float32 by contract: cast from float64 values within 1e-9,
    it agrees to one float32 rounding, 1e-7;
  * the events' `delay_started`, the done flags and the step counts agree
    exactly: both decide on the same float64 values, none within 1e-9 of
    its threshold here;
  * a launch is held to its own definition too (the 0.3 m circle at the
    launch's angle, z = float32(0.15), 5 m/s) within 1e-12: the spawn's
    few float64 operations.
"""

import math
import sys

import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import env03

from perf_bench import check, core
from perf_bench.drivers import rollout_block
from perf_bench.reference import envs as ref_envs

F64 = torch.float64
ENV_ID = "Env03-v1"
B = 8
STEPS = 3
TOL = 1e-9
FLYING, WHEEL, SIDE, RESTING, PARKED = (0, 1, 2, 3), 4, 5, 6, 7


def reference():
    cls = ref_envs.load(ENV_ID)
    return cls(core.solver("fast")), sys.modules[cls.__module__]


def start_states(env):
    """The 8 envs of the module's docstring: the reset's robots turned
    upright at yaw 0, their blocks placed about the robot's origin (block
    centre, velocity)."""
    state, _ = env.reset(B)
    qpos = state.phys.qpos.clone()
    qvel = torch.zeros((B, 14), dtype=F64)
    qpos[:, 3:7] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=F64)
    blocks = [((0.0, 0.10, 0.12), (0.0, -5.0, 0.0)),     # front face
              ((0.0, -0.10, 0.12), (0.0, 5.0, 0.0)),     # back face
              ((0.10, 0.0, 0.12), (-5.0, 0.0, 0.0)),     # right side
              ((-0.10, 0.0, 0.12), (5.0, 0.0, 0.0)),     # left side
              ((0.108, 0.0, 0.034), (-1.0, 0.0, 0.0)),   # a wheel's face
              ((0.071, 0.0, 0.13), (-1.0, 0.0, 0.0)),    # the chassis side
              ((0.0, 0.30, 0.0), (0.05, 0.0, 0.0)),      # resting, slow
              ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))]        # parked
    for i, (pos, vel) in enumerate(blocks):
        qpos[i, 9:12] = qpos[i, 0:3] + torch.tensor(pos, dtype=F64)
        qpos[i, 12:16] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=F64)
        qvel[i, 8:11] = torch.tensor(vel, dtype=F64)
    qpos[PARKED, 9:12] = torch.tensor(env03.PARK_POS, dtype=F64)
    started = torch.zeros(B, dtype=torch.bool)
    started[PARKED] = True
    return env.state_from_qpos(qpos, qvel, aux=dict(delay_started=started))


def test_step_matches_the_reference_over_three_steps():
    env = brt.make(ENV_ID, device="cpu", dtype=F64, seed=7).use_fast_solver()
    ref, _ = reference()
    assert (ref.params.newton_iters, ref.params.ls_iters) == (
        env.params.newton_iters, env.params.ls_iters)
    state = start_states(env)
    truth = check.state_dict(state)
    v0 = state.phys.qvel[:, 8:11].clone()
    g = torch.Generator().manual_seed(23)
    near, fired = [], []
    for i in range(STEPS):
        action = torch.rand((B, 2), generator=g, dtype=F64) * 2 - 1
        u = torch.rand((B, 6), generator=g, dtype=F64)
        near.append(rollout_block.within_reach(state.phys.qpos))
        pre_started = state.aux["delay_started"]
        state, obs, reward, term, trunc = env.step(state, action, u)
        truth, r_obs, r_reward, r_term, r_trunc, _ = ref.step(truth, action,
                                                             u)
        for k in ("qpos", "qvel"):
            assert check.gap(getattr(state.phys, k), truth[k]) < TOL, (i, k)
        scale = max(1.0, float(truth["ws"].abs().max()))
        assert float((state.phys.warmstart - truth["ws"]).abs().max()) \
            < TOL * scale
        torch.testing.assert_close(reward, r_reward, rtol=0, atol=TOL)
        assert obs.dtype == torch.float32
        torch.testing.assert_close(obs.double(), r_obs, rtol=0, atol=1e-7)
        assert torch.equal(state.aux["delay_started"],
                           truth["delay_started"])
        assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
        assert torch.equal(state.t, truth["t"])
        assert torch.equal(state.has_last, truth["has_last"])
        for k in ("last_pitch", "last_t"):
            torch.testing.assert_close(getattr(state, k), truth[k], rtol=0,
                                       atol=TOL)
        # each launch from its own uniforms: the angle u[:, 0] x 2 pi on
        # the 0.3 m circle, z = float32(0.15), 5 m/s
        fire = pre_started & ~state.aux["delay_started"]
        fired.append(fire)
        q, v = state.phys.qpos[fire], state.phys.qvel[fire]
        angle = u[fire, 0] * 2 * math.pi
        rel = torch.stack((torch.sin(angle), torch.cos(angle)), -1) * 0.3
        torch.testing.assert_close(q[:, 9:11] - q[:, 0:2], rel, rtol=0,
                                   atol=1e-12)
        assert bool((q[:, 11] == env03.SPAWN_Z).all())
        torch.testing.assert_close(v[:, 8:11].norm(dim=-1),
                                   torch.full_like(angle, 5.0), rtol=0,
                                   atol=1e-12)
    # the parked block fired at the first step, the slow one parked then
    # and fired at the second; the blocks at the robot were in reach and
    # struck it (their horizontal velocity, which nothing but a contact
    # changes, changed by a tenth of their speed or more)
    assert [f.nonzero().flatten().tolist() for f in fired] == [
        [PARKED], [RESTING], []]
    assert bool(near[0][list(FLYING) + [WHEEL, SIDE]].all())
    assert not bool(near[0][[RESTING, PARKED]].any())
    change = (state.phys.qvel[:, 8:10] - v0[:, :2]).norm(dim=-1)
    hit = change > 0.1 * v0.norm(dim=-1)
    assert bool(hit[list(FLYING) + [WHEEL, SIDE]].all()), hit


def test_the_reset_is_fresh_to_the_reference():
    env = brt.make(ENV_ID, device="cpu", seed=3)
    state, obs = env.reset(512)
    ref, _ = reference()
    s = check.cast(check.state_dict(state), F64)
    assert bool(ref.fresh(s, obs.double()).all())
    # a block off the circle, slower, too high or aimed away; a chassis
    # pitched beyond the reset's range: no fresh episode
    bad_q, bad_v = s["qpos"].clone(), s["qvel"].clone()
    bad_q[0, 9] += 0.01
    bad_v[1, 8:11] *= 0.9
    bad_q[2, 11] += 1e-4
    bad_v[3, 8:10] *= -1
    half = 0.25
    bad_q[4, 3:7] = torch.tensor((0.0, math.sin(half), 0.0, math.cos(half)),
                                 dtype=F64)
    ok = ref.fresh(dict(s, qpos=bad_q, qvel=bad_v), obs.double())
    assert ok.tolist()[:5] == [False] * 5 and bool(ok[5:].all())


def test_the_reference_writes_out_the_ports_constants():
    ref, ref_mod = reference()
    port = env03.Env03V1
    assert ref.max_episode_steps == port.max_episode_steps == 6000
    assert (ref.block_delay, ref.block_speed) == (port.block_delay,
                                                  port.block_speed)
    assert ref.jitter == port._target_jitter(None)
    assert ref.n_uniforms == 6
    assert ref_mod.RESET_YZ == port.reset_y_range == port.reset_z_range
    assert rollout_block.REACH == pytest.approx(0.25417, abs=5e-6)
    config = core.load_json(core.ROOT / "perf_bench/configs/env03v1.json")
    assert config["env_id"] == ENV_ID and config["reduced"] == []

