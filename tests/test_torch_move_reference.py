"""The port's EnvMove05-v1 step held to the benchmark's plain reference
(`perf_bench/reference/envs/EnvMove05-v1.py` and `reference/quant.py`) on
the CPU: the lidar reward, the int8 inner policy's action, the wall
physics and the outer obs, over 10 control steps from fresh states and from
states pressed against a wall and into a corner; and the int8 policy
itself, unit by unit, on 4,096 seeded obs.

Tolerances, each with its reason:
  * the states (qpos, qvel; the warm start relative to its scale, qacc up
    to ~1e4), the reward and the servo targets agree within 1e-9 after 10
    steps: both sides run the same float64 arithmetic of the same
    equations, and the reference is a frozen copy that a later change of
    the port's summation order may only move by rounding, which stays far
    below 1e-9 over 10 steps (it reads 0 today);
  * the obs is float32 by contract: cast from float64 values within 1e-9,
    it agrees to one float32 rounding, 1e-7;
  * done flags, step counts and the int8 policy's integers agree exactly:
    the inner obs is cast to float32 from the same float64 values, the
    accumulators are exact integers, the multipliers and their products
    float32 on both sides; only tanh differs (the port's float32 tanh
    against the reference's correctly rounded one), which moves an integer
    only where tanh x 128 lies within an ulp of a half-integer, as none of
    these obs does.
"""

import math
import sys

import numpy as np
import torch

import balance_robot_tpu_torch as brt
import chip_smoke
from balance_robot_tpu_torch.envs import move
from balance_robot_tpu_torch.envs.base import tree_map
from balance_robot_tpu_torch.export.pipeline import load_brq
from balance_robot_tpu_torch.ops import quant

from perf_bench import check, core
from perf_bench.reference import envs as ref_envs, quant as ref_quant
from perf_bench.reference.physics import step as ref_step

F64 = torch.float64
ENV_ID = "EnvMove05-v1"
STEPS = 10
TOL = 1e-9
N_OBS = 4096


def reference():
    cls = ref_envs.load(ENV_ID)
    return cls(core.solver("fast")), sys.modules[cls.__module__]


def start_states(env):
    """8 envs: 2 fresh episodes of the port's reset, then chip_smoke.py's
    wall states, one of each kind (side face flush, wheel rim rubbing,
    leaning on its top edge, in a corner against two walls, lying flat on
    the wall, lifted onto its edge), with the target speeds of a reset."""
    fresh, _ = env.reset(2)
    qpos, qvel, _ = chip_smoke.random_states_walls(np.random.default_rng(4),
                                                   6)
    walls = env.state_from_qpos(
        torch.tensor(qpos), torch.tensor(qvel),
        target_wheel_speed=torch.linspace(31.0, 40.0, 6, dtype=F64))
    return tree_map(lambda a, b: torch.cat((a, b)), fresh, walls)


def test_the_start_states_take_every_wall_collider():
    """Within the first 20 substeps from the wall states, every kind of
    wall contact is included: chassis faces, edges and flush faces, the
    wheels, and two walls at once (the corner)."""
    env = brt.make(ENV_ID, device="cpu", dtype=F64, seed=7)
    s = start_states(env)
    ref, _ = reference()
    seen = {}
    ctrl = s.phys.qvel[:, 6:8]
    ref_step.control_step(ref_step.PhysState(*s.phys), ctrl, ref.params,
                          frame_skip=20, contact_counts=seen)
    assert set(seen) == set(ref_step.WALL_CONTACT_KINDS)
    assert all(bool(hit[2:].any()) for hit in seen.values()), {
        k: v.tolist() for k, v in seen.items()}
    assert not any(bool(hit[:2].any()) for hit in seen.values())


def test_step_matches_the_reference_over_ten_steps():
    env = brt.make(ENV_ID, device="cpu", dtype=F64, seed=7).use_fast_solver()
    ref, ref_mod = reference()
    assert (ref.params.newton_iters, ref.params.ls_iters) == (
        env.params.newton_iters, env.params.ls_iters)
    state = start_states(env)
    truth = check.state_dict(state)
    g = torch.Generator().manual_seed(21)
    u = torch.zeros((8, 0), dtype=F64)
    inner_seen, near_wall = set(), 0
    for _ in range(STEPS):
        action = torch.rand((8, 2), generator=g, dtype=F64) * 2 - 1
        # the lidar the reward reads, and the servo targets the inner
        # policy sets, from the same pre-step state
        lidar = move.lidar_distances(state.phys.qpos)
        torch.testing.assert_close(lidar, ref_mod.lidar(truth["qpos"]),
                                   rtol=0, atol=TOL)
        near_wall += int((lidar[:, 2:6] < move.LIDAR_RANGE).sum())
        ctrl = env.wheel_ctrl(state, action)[1]
        torch.testing.assert_close(ctrl, ref.ctrl(truth, action)[0],
                                   rtol=0, atol=TOL)
        inner_seen.update(((ctrl - state.phys.qvel[:, 6:8]) / 4.0).round(
            decimals=6).flatten().tolist())

        state, obs, reward, term, trunc = env.step(state, action, u)
        truth, r_obs, r_reward, r_term, r_trunc, _ = ref.step(
            truth, action, u)
        for k in ("qpos", "qvel"):
            assert check.gap(getattr(state.phys, k), truth[k]) < TOL, k
        scale = max(1.0, float(truth["ws"].abs().max()))
        assert float((state.phys.warmstart - truth["ws"]).abs().max()) \
            < TOL * scale
        torch.testing.assert_close(reward, r_reward, rtol=0, atol=TOL)
        assert obs.dtype == r_obs.dtype == torch.float32
        torch.testing.assert_close(obs, r_obs, rtol=0, atol=1e-7)
        assert (obs[:, 2:] == 0).all()
        assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
        assert torch.equal(state.t, truth["t"])
        assert torch.equal(state.has_last, truth["has_last"])
        assert torch.equal(state.last_t, truth["last_t"])
        for k in ("last_pitch", "target_wheel_speed", "target_yaw"):
            torch.testing.assert_close(getattr(state, k), truth[k], rtol=0,
                                       atol=TOL)
    # the inner policy's action moved, and the reward saw walls in range
    assert len(inner_seen) > 10
    assert near_wall > 0


def seeded_obs():
    """4,096 inner obs: uniform over twice the quantizer's range (so about
    half of the inputs clip at -128 or 127), with rows exactly at the clip
    edges, at the last values inside them and at zero."""
    qm = load_brq(move.INNER_POLICY_ASSET)
    s = qm.in_q.scale
    g = torch.Generator().manual_seed(19)
    obs = (torch.rand((N_OBS, 6), generator=g) * 2 - 1) * 256 * s
    edges = torch.tensor([-128.0, -127.0, 0.0, 126.0, 127.0, 128.0]) * s
    obs[:6] = edges.unsqueeze(1).expand(6, 6)
    obs[6:12] = edges.unsqueeze(0).expand(6, 6)
    return qm, obs.to(torch.float32)


def test_int8_policy_matches_the_reference_on_4096_obs():
    qm, obs = seeded_obs()
    art = ref_quant.load(move.INNER_POLICY_ASSET)
    q_port = quant.quantize_obs(obs, qm.in_q)
    q_ref = ref_quant.quantize(art, obs)
    assert torch.equal(q_port.to(F64), q_ref)
    assert bool((q_ref == -128).any()) and bool((q_ref == 127).any())
    # the same int8 inputs through both forwards
    out_port = quant.int8_forward(qm, q_port)
    out_ref = ref_quant.forward(art, q_ref)
    bad = (out_port.to(F64) != out_ref).any(1).nonzero().flatten()
    assert bad.numel() == 0, f"{bad.numel()} rows differ: {bad[:5].tolist()}"
    assert out_ref.unique().numel() > 20
    act_port = quant.dequantize_action(out_port, qm.out_q)
    assert torch.equal(act_port, ref_quant.dequantize(art, out_ref))
    assert torch.equal(quant.int8_policy_fn(qm, "cpu")(obs),
                       ref_quant.act(art, obs))


def test_the_reset_is_fresh_to_the_reference():
    env = brt.make(ENV_ID, device="cpu", seed=3)
    state, obs = env.reset(512)
    ref, _ = reference()
    s = check.cast(check.state_dict(state), F64)
    assert bool(ref.fresh(s, obs.double()).all())
    tws = state.target_wheel_speed
    assert float(tws.min()) >= 31.0 and float(tws.max()) <= 40.0
    # a start with its wheels turning, its fd pitch_dot state seeded, its
    # yaw beyond the reset's range or a lidar slot set is no fresh episode
    for key, change in (("qvel", lambda v: v.index_fill(1, torch.tensor(
            [6]), 1.0)), ("has_last", lambda v: torch.ones_like(v))):
        bad = dict(s, **{key: change(s[key])})
        assert not bool(ref.fresh(bad, obs.double()).any()), key
    turned = s["qpos"].clone()
    half = math.radians(15.0)
    turned[:, 3:7] = torch.tensor([0.0, 0.0, math.sin(half), math.cos(half)],
                                  dtype=F64)
    assert not bool(ref.fresh(dict(s, qpos=turned), obs.double()).any())
    slot = obs.double().clone()
    slot[:, 5] = 0.1
    assert not bool(ref.fresh(s, slot).any())


def test_the_reference_writes_out_the_ports_scene_and_artifact():
    """The walls, rays, range and sensor height of envMove05_v1.xml /
    RobotMoveBaseEnv.py as the port has them, the artifact the config
    names, and the solver grade's settings."""
    ref, ref_mod = reference()
    assert ref_mod.WALLS == move.WALLS
    np.testing.assert_allclose(ref_mod.RAY_ANGLES, move.RAY_ANGLES, rtol=0,
                               atol=1e-15)
    assert (ref_mod.LIDAR_RANGE, ref_mod.LIDAR_HEIGHT, ref_mod.FLOOR_Z) == (
        move.LIDAR_RANGE, move.LIDAR_HEIGHT, move.FLOOR_Z)
    assert ref.max_episode_steps == move.EnvMove05.max_episode_steps == 700
    assert ref.n_uniforms == 0
    config = core.load_json(core.ROOT / "perf_bench/configs/envmove05.json")
    assert (core.ROOT / config["inner_policy"]).resolve() == \
        ref_mod.INNER_POLICY == move.INNER_POLICY_ASSET.resolve()
    assert config["env_id"] == ENV_ID and config["reduced"] == []
