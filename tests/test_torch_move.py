"""The port's move stack against the JAX package (CPU): the wall physics
(the plain version of kernel K3), the lidar, EnvMove05-v1 with its int8
inner policy, Cal01, and the EnvMove05 slice as a whole.

Same inputs (numpy, from a seed) through both packages. Physics and envs run
in float64 (`jax_enable_x64`): both sides do the same arithmetic in another
order, so states agree to rounding (1e-10 leaves room for 250-substep
control steps through stiff contacts; the warm start is qacc, up to ~1e4,
so it is compared relative to its scale). obs are float32 by contract and
agree to one float32 ulp. The one float32 test holds the plain wall physics
to the JAX package's float32 XLA wall path (the reference of its own
Pallas-kernel test) and comes first, before x64 is switched on for the rest
of the module.
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
from balance_robot_tpu.envs import move as jmove
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.physics import fast_solver as jfast_solver
from balance_robot_tpu.physics import step as jst

import chip_smoke
import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import base, move
from balance_robot_tpu_torch.envs.vector import VecEnv
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.physics import cuda_move, fast_solver
from balance_robot_tpu_torch.train import checkpoint

torch.set_num_threads(1)
F64 = torch.float64
POLICY = "models/EnvMove05-v1_PPO_r4/best_model.npz"


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_wall_test_states(B, rng):
    """The states of the JAX package's wall-kernel test: the robot near the
    +x wall (inner face x = 0.24), some overlapping it, sliding wall-ward."""
    qpos = np.tile([0.2, 0.0, 0.0, 1, 0, 0, 0, 0, 0], (B, 1)).astype(
        np.float64)
    qpos[:, 0] = np.linspace(0.18, 0.21, B)
    qpos[:, 1] = rng.normal(size=B) * 0.02
    qvel = np.zeros((B, 8))
    qvel[:, 0] = 2.0
    qvel[:, 6] = rng.normal(size=B) * 5
    qvel[:, 7] = rng.normal(size=B) * 5
    return qpos, qvel, rng.normal(size=(B, 2)) * 5


def wall_states():
    """Those 4 states and 12 of chip_smoke.py's (wheel-first, leaning, corner,
    flush slide, edge: 2 of each kind)."""
    a = jax_wall_test_states(4, np.random.default_rng(0))
    b = chip_smoke.random_states_walls(np.random.default_rng(1), 12)
    return tuple(np.concatenate(pair) for pair in zip(a, b))


# ------------------------------------------------------------ wall physics

@functools.lru_cache(maxsize=None)
def _jax_wall_step(fast, frame_skip):
    params = jmove.MOVE05_PARAMS
    params = jfast_solver(params) if fast else params

    def one(qp, qv, c):
        s = jst.PhysState(qpos=tuple(qp), qvel=tuple(qv),
                          warmstart=(jnp.zeros(()),) * 8)
        out = jst.control_step(s, (c[0], c[1]), params,
                               frame_skip=frame_skip)
        return (jnp.stack(out.qpos), jnp.stack(out.qvel),
                jnp.stack(out.warmstart))
    return jax.jit(jax.vmap(one))


def test_plain_wall_physics_matches_jax_in_float32():
    """float32, 3 substeps spanning wall contact, on the JAX wall-kernel
    test's own states: the port's plain version against the JAX package's
    XLA wall path, to which that test holds the interpret-mode Pallas kernel
    at 1e-7 / 1e-4. (Tracing the fused wall kernel in interpret mode takes
    about two minutes on a CPU, so it is not repeated here.) Differently
    structured float32 programs: qpos to 1e-6, qvel to 1e-3."""
    assert not jax.config.jax_enable_x64
    qpos, qvel, ctrl = (x.astype(np.float32) for x in jax_wall_test_states(
        4, np.random.default_rng(0)))
    kq, kv, _ = _jax_wall_step(False, 3)(qpos, qvel, ctrl)
    assert kq.dtype == jnp.float32
    seen = {}
    mq, mv, mw = cuda_move.control_step_walls_plain(
        torch.tensor(qpos), torch.tensor(qvel), torch.zeros(4, 8),
        torch.tensor(ctrl), move.MOVE05_PARAMS, frame_skip=3,
        contact_counts=seen)
    assert mq.dtype == torch.float32
    assert int(seen["chassis_wall_face"].sum()) >= 2
    np.testing.assert_allclose(mq, np.asarray(kq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(mv, np.asarray(kv), rtol=0, atol=1e-3)
    # the wall pushed back: the step is not the flat-floor one
    assert np.abs(np.asarray(kv)[:, 0] - 2.0).max() > 1e-2


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_wall_control_step_matches_jax(x64, fast):
    qpos, qvel, ctrl = wall_states()
    jq, jv, jw = _jax_wall_step(fast, 3)(qpos, qvel, ctrl)
    params = fast_solver(move.MOVE05_PARAMS) if fast else move.MOVE05_PARAMS
    seen = {}
    mq, mv, mw = cuda_move.control_step_walls_plain(
        torch.tensor(qpos), torch.tensor(qvel),
        torch.zeros(len(qpos), 8, dtype=F64), torch.tensor(ctrl), params,
        frame_skip=3, contact_counts=seen)
    # every wall contact kind took part
    assert all(int(v.sum()) > 0 for v in seen.values()), seen
    np.testing.assert_allclose(mq, np.asarray(jq), rtol=0, atol=1e-10)
    np.testing.assert_allclose(mv, np.asarray(jv), rtol=0, atol=1e-10)
    scale = max(1.0, float(np.abs(np.asarray(jw)).max()))
    np.testing.assert_allclose(mw / scale, np.asarray(jw) / scale, rtol=0,
                               atol=1e-9)


# ------------------------------------------------------------ lidar

def quat_of(yaw, pitch):
    """Chassis quaternion: pitch about the wheel axis, then yaw."""
    qy = np.array([math.cos(yaw / 2), 0, 0, math.sin(yaw / 2)])
    qp = np.array([math.cos(pitch / 2), math.sin(pitch / 2), 0, 0])
    w1, x1, y1, z1 = qy
    w2, x2, y2, z2 = qp
    return np.array([w1*w2 - x1*x2 - y1*y2 - z1*z2,
                     w1*x2 + x1*w2 + y1*z2 - z1*y2,
                     w1*y2 - x1*z2 + y1*w2 + z1*x2,
                     w1*z2 + x1*y2 - y1*x2 + z1*w2])


def lidar_poses():
    """qpos (N, 9): the corridor's centre, facing a wall within range,
    pitched so the rays meet the floor, inside a wall, unnormalized and
    zero-w quaternions, and seeded random poses."""
    rng = np.random.default_rng(8)
    rows = [([0.0, 0.0, 0.0], quat_of(0.0, 0.0)),
            ([0.1, 0.0, 0.0], quat_of(-math.pi / 2, 0.0)),
            ([0.0, 0.85, 0.0], quat_of(0.0, 0.05)),
            ([0.0, 0.0, 0.0], quat_of(0.3, -0.45)),
            ([0.0, 0.0, 0.0], quat_of(0.3, 0.45)),
            ([0.245, 0.2, 0.0], quat_of(1.0, 0.0)),
            ([0.1, -0.8, 0.01], 3.0 * quat_of(2.5, 0.1)),
            ([0.0, 0.0, 0.0], np.array([0.0, 0.0, 1.0, 0.0]))]
    for _ in range(40):
        rows.append((rng.uniform(-1, 1, 3) * [0.22, 0.95, 0.02],
                     quat_of(rng.uniform(-math.pi, math.pi),
                             rng.normal() * 0.3)))
    qpos = np.zeros((len(rows), 9))
    for i, (pos, quat) in enumerate(rows):
        qpos[i, :3], qpos[i, 3:7] = pos, quat
    return qpos


def test_lidar_matches_jax(x64):
    qpos = lidar_poses()
    ref = np.asarray(jax.vmap(jmove.lidar_distances)(jnp.asarray(qpos)))
    mine = move.lidar_distances(torch.tensor(qpos)).numpy()
    assert mine.shape == (len(qpos), 8)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12)
    # centre: nothing within range; facing the wall at 0.14 m: real readings;
    # pitched towards the floor: the floor hits are rejected
    assert (mine[0] == move.LIDAR_RANGE).all()
    assert (mine[1] < 0.25).sum() >= 4 and (mine[1] > 0.1).all()
    assert (mine[3] == move.LIDAR_RANGE).all() \
        or (mine[4] == move.LIDAR_RANGE).all()
    assert ((mine >= 0) & (mine <= move.LIDAR_RANGE)).all()

    R = np.stack([np.asarray(jnp.stack([jnp.stack(r) for r in jmove.qmat(
        tuple(q / np.linalg.norm(q)))])) for q in qpos[:, 3:7]])
    origin = qpos[:, :3] + R[:, :, 2] * move.LIDAR_HEIGHT
    dirs = move.RAY_DIRS_LOCAL @ R.transpose(0, 2, 1)
    ref_t = np.asarray(jax.vmap(jmove.raycast)(jnp.asarray(origin),
                                               jnp.asarray(dirs)))
    mine_t = move.raycast(torch.tensor(origin), torch.tensor(dirs)).numpy()
    assert np.isinf(ref_t).any() and np.isfinite(ref_t).any()
    np.testing.assert_array_equal(np.isinf(mine_t), np.isinf(ref_t))
    fin = np.isfinite(ref_t)
    np.testing.assert_allclose(mine_t[fin], ref_t[fin], rtol=0, atol=1e-12)
    # a ray that starts inside a wall reports its exit distance
    assert (mine_t[5] < 0.03).any()
    # the floor is hit where the rejection fired
    assert (mine_t[3] < 0.3).any() or (mine_t[4] < 0.3).any()
    np.testing.assert_array_equal(move.RAY_DIRS_LOCAL, jmove.RAY_DIRS_LOCAL)
    assert move.WALLS == jmove.WALLS


# ------------------------------------------------------------ EnvMove05

@functools.lru_cache(maxsize=None)
def _jax_control_step(params):
    return jax.jit(lambda phys, ctrl, fric: jst.control_step(
        phys, ctrl, params, friction=fric))


def jax_move_env():
    env = jbrt.make("EnvMove05-v1").use_fast_solver()
    env._pallas_cs = _jax_control_step(env.params)
    return env


def move_start_states(n):
    """Upright-ish, rolling along the corridor at about the target speed;
    env 0 starts beside the +x wall and drifts into it."""
    rng = np.random.default_rng(12)
    qpos = np.zeros((n, 9))
    qpos[:, 0] = rng.uniform(-0.1, 0.1, n)
    qpos[:, 1] = rng.uniform(-0.5, 0.5, n)
    qpos[:, 2] = -0.0205
    for i in range(n):
        qpos[i, 3:7] = quat_of(rng.uniform(-0.2, 0.2),
                               rng.uniform(-0.1, 0.1))
    qvel = rng.normal(size=(n, 8)) * np.array([.01, .01, .01, .2, .2, .2, 0,
                                               0])
    qvel[:, 6], qvel[:, 7] = 30.0, -30.0
    qpos[0, 0], qpos[0, 3:7] = 0.15, quat_of(0.12, 0.02)
    qvel[0, 0] = 0.5
    return qpos, qvel, rng.uniform(31, 40, n)


def both_states(jenv, env, qpos, qvel, tws):
    js = jax.vmap(lambda q, v: jenv.state_from_qpos(q, v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    js = js._replace(target_wheel_speed=jnp.asarray(tws))
    ts = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel),
                             target_wheel_speed=torch.tensor(tws))
    return js, ts


def assert_same_step(js, jout, ts, out):
    jobs, jr, jterm, jtrunc = jout
    obs, r, term, trunc = out
    np.testing.assert_allclose(ts.phys.qpos,
                               np.stack(js.phys.qpos, -1), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.phys.qvel,
                               np.stack(js.phys.qvel, -1), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-9)
    assert obs.dtype == torch.float32 and jobs.dtype == jnp.float32
    np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(term, jterm)
    np.testing.assert_array_equal(trunc, jtrunc)
    np.testing.assert_allclose(ts.last_pitch, js.last_pitch, atol=1e-10)
    np.testing.assert_array_equal(ts.last_t, js.last_t)
    np.testing.assert_allclose(ts.target_wheel_speed, js.target_wheel_speed,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.target_yaw, js.target_yaw, rtol=0,
                               atol=1e-12)


def test_move05_trajectory_matches_jax(x64):
    """10 control steps from the same states with the packaged int8 inner
    policy and fixed float32 actions: obs, reward, termination, the inner
    policy's action and the state."""
    B = 3
    jenv = jax_move_env()
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64).use_fast_solver()
    js, ts = both_states(jenv, env, *move_start_states(B))
    jstep = jax.vmap(jenv.step)
    jctrl = jax.vmap(lambda s, a: jenv._step_wheel_speeds(
        s, a[0] * 20.0, a[1] * jbase.YAW_MAX)[1])
    inner_seen = set()
    for t in range(10):
        a = np.tile([1.7 + 0.1 * math.sin(t), 0.3 * math.cos(0.7 * t)],
                    (B, 1)).astype(np.float32) * np.linspace(
                        0.9, 1.1, B, dtype=np.float32)[:, None]
        # the inner policy's action, from the servo targets both would send
        j_inner = (np.stack(jctrl(js, jnp.asarray(a)), -1)
                   - np.stack(js.phys.qvel[6:], -1)) / 4.0
        inner = (env.wheel_ctrl(ts, torch.tensor(a))[1]
                 - ts.phys.qvel[:, 6:8]) / 4.0
        np.testing.assert_allclose(inner, j_inner, rtol=0, atol=1e-12)
        inner_seen.update(np.round(inner.numpy().ravel(), 6))
        js, *jout = jstep(js, jnp.asarray(a))
        ts, *out = env.step(ts, torch.tensor(a))
        assert_same_step(js, jout, ts, out)
        assert (out[0][:, 2:] == 0).all()
    assert ts.t.tolist() == [10] * B and ts.has_last.all()
    # the int8 policy's output moved, and the reward saw a wall within range
    assert len(inner_seen) > 10
    near = move.lidar_distances(ts.phys.qpos)[:, 2:6]
    assert (near < move.LIDAR_RANGE).any()


def test_slice_move05_deterministic_policy(x64):
    """The slice as a whole: EnvMove05-v1 (fast solver), the checked-in outer
    policy acting deterministically on each side's own obs, the packaged
    int8 inner policy inside the step, 5 control steps, float64."""
    B, steps = 3, 5
    d = checkpoint.load(POLICY)
    assert d["pi_w1"].shape == (10, 64)
    jd = {k: jnp.asarray(v, jnp.float64) for k, v in d.items()}
    net = mlp.from_numpy_params(d, dtype=F64)
    jenv = jax_move_env()
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64).use_fast_solver()
    js, ts = both_states(jenv, env, *move_start_states(B))
    jobs = jax.vmap(lambda s: jenv._obs(s)[0])(js)
    obs = env._obs(ts)
    np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-7)
    jstep = jax.vmap(jenv.step)
    for _ in range(steps):
        ja = jnp.clip(jmlp.policy_mean(jd, jobs.astype(jnp.float64)), -1, 1)
        with torch.no_grad():
            a = net.policy_mean(obs.double()).clamp(-1.0, 1.0)
        np.testing.assert_allclose(a, ja, rtol=0, atol=1e-8)
        js, *jout = jstep(js, ja)
        ts, *out = env.step(ts, a)
        assert_same_step(js, jout, ts, out)
        jobs, obs = jout[0], out[0]
    assert np.abs(np.asarray(ja)).max() > 0.05


def closed_loop_rollout(tmp_path, B, T):
    """T control steps (250 substeps each) of closed-loop serving at the
    exact grade, float64: the port (its physics run by kernel K3's own
    source, compiled for the host) against the JAX env, both under the
    checked-in outer policy in float32. The return of this policy hangs on
    the 4th digit of its output, so equal returns over many steps are the
    evidence that the port serves it as the JAX package does. Returns both
    sides' per-episode returns."""
    import shutil
    import subprocess
    from balance_robot_tpu_torch.physics import kernel_build
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to compile the kernel source")
    so = tmp_path / "k3.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(kernel_build.CSRC / cuda_move.SOURCE)],
                   check=True)
    lib = cuda_move._bind(so)
    d = checkpoint.load(POLICY)
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    net = mlp.from_numpy_params(d, dtype=torch.float32)
    jenv = jbrt.make("EnvMove05-v1")
    jenv._pallas_cs = _jax_control_step(jenv.params)
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64, seed=4)
    ts, obs = env.reset(B)
    js, _ = both_states(jenv, env, ts.phys.qpos.numpy(),
                        ts.phys.qvel.numpy(), ts.target_wheel_speed.numpy())
    jobs = jnp.asarray(obs.numpy())
    jstep = jax.jit(jax.vmap(jenv.step))

    def k3_on_the_host(qpos, qvel, ws, ctrl, friction, params,
                       frame_skip=250):
        return tuple(cuda_move.count_ops(qpos, qvel, ws, ctrl, params,
                                         frame_skip, lib=lib)[1:])

    ret, jret = np.zeros(B), np.zeros(B)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(move, "control_step", k3_on_the_host)
        for _ in range(T):
            with torch.no_grad():
                a = net.policy_mean(obs).clamp(-1.0, 1.0)
            ja = jnp.clip(jmlp.policy_mean(jd, jobs), -1, 1)
            ts, obs, r, term, _ = env.step(ts, a)
            js, jobs, jr, jterm, _ = jstep(js, ja)
            ret += r.numpy()
            jret += np.asarray(jr)
            np.testing.assert_array_equal(term, jterm)
    np.testing.assert_allclose(ts.phys.qpos, np.stack(js.phys.qpos, -1),
                               rtol=0, atol=1e-6)
    # the two float32 policy forwards differ by an ulp, 1e-4 of an output
    # near 0.001, and on the reward's spikes the reward goes as 1 / output
    np.testing.assert_allclose(ret, jret, rtol=1e-4)
    print("returns after", T, "steps: port", ret, "JAX", jret)
    return ret, jret


def test_move05_closed_loop_rollout_matches_jax(x64, tmp_path):
    """25 full control steps, 2 episodes: about a minute on a CPU."""
    ret, _ = closed_loop_rollout(tmp_path, 2, 25)
    assert ret.min() > 0


@pytest.mark.slow
def test_move05_long_rollout_matches_jax(x64, tmp_path):
    """300 control steps, 4 episodes: about 5 minutes on a CPU."""
    ret, _ = closed_loop_rollout(tmp_path, 4, 300)
    assert ret.mean() > 300


def test_move05_reset_distribution():
    """qpos noise in +-0.01 (z = 0), the scrambled quaternion with y/z
    ranges 0.2, zero velocity, target speed U(1, 10) + 30, an empty fd
    pitch_dot state and the obs with its zeroed lidar slots."""
    from scipy.spatial.transform import Rotation
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64, seed=3)
    s, obs = env.reset(1000)
    qpos = s.phys.qpos.numpy()
    assert np.abs(qpos[:, [0, 1, 7, 8]]).max() <= 0.01
    assert (qpos[:, 2] == 0).all() and (s.phys.qvel == 0).all()
    np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7], axis=1), 1.0,
                               atol=1e-12)
    euler = Rotation.from_quat(qpos[:, 3:7]).as_euler("xyz")
    for k, r in enumerate((math.pi, 0.2, 0.2)):
        assert 0.95 * r < np.abs(euler[:, k]).max() <= r + 1e-9
    tws = s.target_wheel_speed.numpy()
    assert tws.min() >= 31.0 and tws.max() <= 40.0
    assert tws.min() < 31.2 and tws.max() > 39.8 and abs(
        tws.mean() - 35.5) < 0.3
    assert (s.target_yaw == 0).all() and (s.t == 0).all()
    assert not s.has_last.any() and (s.last_pitch == 0).all()
    assert obs.shape == (1000, 10) and obs.dtype == torch.float32
    assert (obs == 0).all()
    # the first step's inner obs reads pitch_dot = 0 and anchors the fd state
    s2, _ = env.wheel_ctrl(s, torch.zeros(1000, 2))
    assert s2.has_last.all()
    np.testing.assert_allclose(s2.last_pitch, base.pitch_of(s.phys.qpos))


def test_vecenv_auto_reset_redraws_the_target_speed():
    """A done env starts a fresh episode with the reset's own target speed
    draw; the others keep the speed the outer action commanded."""
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64,
                   seed=5).use_fast_solver()
    vec = VecEnv(env, 3)
    qpos, qvel, tws = move_start_states(3)
    qpos[1, 3:7] = quat_of(0.0, math.radians(55.0))     # fallen
    s = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel),
                            target_wheel_speed=torch.tensor(tws))
    s = s._replace(t=torch.tensor([3, 9, env.max_episode_steps - 1],
                                  dtype=torch.int32))
    a = torch.tensor([[0.5, 0.1]] * 3)
    ref_state, ref_obs, ref_r, _, _ = env.step(s, a)
    s2, out = vec.step(s, a)
    assert out.terminated.tolist() == [False, True, False]
    assert out.truncated.tolist() == [False, False, True]
    torch.testing.assert_close(out.terminal_obs, ref_obs, rtol=0, atol=0)
    torch.testing.assert_close(out.reward, ref_r, rtol=0, atol=0)
    assert s2.target_wheel_speed[0] == 10.0 and s2.target_yaw[0] == 0.1 * 45
    fresh = s2.target_wheel_speed[1:]
    assert ((fresh >= 31.0) & (fresh <= 40.0)).all() and fresh[0] != fresh[1]
    assert (s2.target_yaw[1:] == 0).all() and s2.t.tolist() == [4, 0, 0]
    assert not s2.has_last[1:].any() and s2.has_last[0]
    assert (out.obs[1:] == 0).all() and (s2.phys.qvel[1:] == 0).all()
    base.tree_map(lambda x, y: torch.testing.assert_close(
        x[0], y[0], rtol=0, atol=0), s2, ref_state)


# ------------------------------------------------------------ Cal01

def test_cal01_matches_jax(x64):
    """Reset pose (z = 0.15, the scrambled euler (0, 0, pi)), 3 steps at the
    constant ctrl = [20, 20] whatever the action, telemetry, and the
    termination once the simulated time exceeds 1.0 s."""
    jenv = jbrt.make("Cal01")
    env = brt.make("Cal01", device="cpu", dtype=F64)
    js, jobs = jenv.reset(jax.random.PRNGKey(0))
    ts, obs = env.reset(2)
    np.testing.assert_allclose(ts.phys.qpos[0], np.stack(js.phys.qpos),
                               rtol=0, atol=1e-15)
    assert ts.phys.qpos[0, 2] == 0.15 and abs(ts.phys.qpos[0, 5] - 1) < 1e-15
    np.testing.assert_allclose(obs[0], jobs, rtol=0, atol=1e-7)
    torch.testing.assert_close(obs[0], obs[1], rtol=0, atol=0)
    jstep = jax.jit(jenv.step)
    for t in range(3):
        js, jobs, jr, jterm, jtrunc = jstep(js, jnp.zeros(2))
        ts, obs, r, term, trunc = env.step(
            ts, torch.tensor([[0.3, -1.0], [-0.7, 0.2]]))
        np.testing.assert_allclose(ts.phys.qpos[0], np.stack(js.phys.qpos),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(ts.phys.qvel[1], np.stack(js.phys.qvel),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(r[0], jr, rtol=0, atol=1e-9)
        np.testing.assert_allclose(obs[0], jobs, rtol=0, atol=1e-6)
        assert term.tolist() == [bool(jterm)] * 2 == [False, False]
        assert trunc.tolist() == [bool(jtrunc)] * 2
        time, vel_l, vel_r = env.telemetry(ts)
        jtime, jl, jr_ = jenv.telemetry(js)
        assert time[0] == float(jtime) and time.dtype == torch.float32
        np.testing.assert_allclose([vel_l[0], vel_r[0]], [jl, jr_], rtol=0,
                                   atol=1e-10)
        # the wheels spin up under the constant servo target
        assert vel_l[0] > 1 and vel_r[0] > 1
    # 200 steps are 1.0 s, not yet over it; the 201st terminates
    for t0 in (198, 199, 200):
        js_t = js._replace(t=jnp.int32(t0))
        ts_t = ts._replace(t=torch.full((2,), t0, dtype=torch.int32))
        _, _, _, jterm, _ = jstep(js_t, jnp.zeros(2))
        _, _, _, term, _ = env.step(ts_t, torch.zeros(2, 2))
        assert term.tolist() == [bool(jterm)] * 2
        assert bool(jterm) == (t0 == 200)
