"""The port's package rules: no JAX, CUDA by default, device dispatch.

Runs anywhere: without a GPU the entry points must raise unless the CPU is
asked for, and the kernels' wrappers (K1, K2, K3) must take the plain version
for CPU tensors and never fall back to it for CUDA ones. The tests that
need the card are marked `cuda` and skip without it.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs.vector import VecEnv
from balance_robot_tpu_torch.envs.move import MOVE05_PARAMS
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.physics import block_step as bs
from balance_robot_tpu_torch.physics import cuda_block, cuda_move, cuda_step
from balance_robot_tpu_torch.physics import fast_solver
from balance_robot_tpu_torch.physics import robot_core as rc
from balance_robot_tpu_torch.train import checkpoint

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "balance_robot_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flagship_survival.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 22
    assert {"env03.py", "cuda_block.py", "kernel_build.py", "cuda_move.py",
            "move.py", "cal01.py", "quant.py", "pipeline.py", "cli.py",
            "onnx_writer.py", "onnx_runtime.py", "native_runtime.py",
            "bc.py", "offpolicy.py", "harvest.py", "distributed.py",
            "mesh.py", "drift.py"} <= {p.name for p in PORT_FILES}
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "balance_robot_tpu",
                               "flax", "optax", "click"), \
                f"{path}: imports {mod}"


def test_registry_has_the_ported_ids():
    assert brt.env_ids() == ["Cal01", "Env01-v1", "Env01-v2", "Env01-v3",
                             "Env02-v1", "Env03-v1", "Env03-v1-fail",
                             "Env03-v2", "EnvMove05-v1"]
    with pytest.raises(KeyError):
        brt.make("EnvMove06-v1", device="cpu")


@pytest.mark.parametrize("env_id", ["Env01-v2", "Env03-v2", "EnvMove05-v1",
                                    "Cal01"])
def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch,
                                                            env_id):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        brt.make(env_id)
    env = brt.make(env_id, device="cpu")
    assert env.device == torch.device("cpu")
    states, obs = VecEnv(env, 2).reset()
    assert obs.device.type == "cpu" and states.phys.qpos.device.type == "cpu"


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        res = _run_chip_smoke(cwd)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("K1 launched for CPU tensors")

    monkeypatch.setattr(cuda_step, "control_step_cuda", refuse)
    monkeypatch.setattr(cuda_step, "launches", 0)
    B = 3
    qpos = torch.zeros(B, 9, dtype=torch.float64)
    qpos[:, 3] = 1.0
    qpos[:, 2] = -0.021
    qvel = torch.zeros(B, 8, dtype=torch.float64)
    ctrl = torch.ones(B, 2, dtype=torch.float64)
    out = cuda_step.control_step(qpos, qvel, qvel, ctrl, None,
                                 rc.ENV01_PARAMS, frame_skip=2)
    ref = cuda_step.control_step_plain(qpos, qvel, qvel, ctrl, None,
                                       rc.ENV01_PARAMS, frame_skip=2)
    assert cuda_step.launches == 0
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_k2(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("K2 launched for CPU tensors")

    monkeypatch.setattr(cuda_block, "control_step14_cuda", refuse)
    monkeypatch.setattr(cuda_block, "launches", 0)
    qpos, qvel, ctrl = block_states(6)
    out = cuda_block.control_step14(qpos, qvel, qvel, ctrl, bs.ENV03_PARAMS,
                                    frame_skip=2)
    ref = cuda_block.control_step14_plain(qpos, qvel, qvel, ctrl,
                                          bs.ENV03_PARAMS, frame_skip=2)
    assert cuda_block.launches == 0
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def wall_states(B, seed=0):
    """chip_smoke.py's robot states in every wall-contact regime, as float64
    CPU tensors qpos (B,9), qvel (B,8), ctrl (B,2)."""
    import numpy as np
    import chip_smoke
    return tuple(torch.tensor(x) for x in chip_smoke.random_states_walls(
        np.random.default_rng(seed), B))


def test_cpu_tensors_take_the_plain_version_k3(monkeypatch):
    """Both the K3 wrapper and the envs' entry `cuda_step.control_step`
    send a wall scene on CPU tensors to the plain wall physics."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launched for CPU tensors")

    monkeypatch.setattr(cuda_move, "control_step_walls_cuda", refuse)
    monkeypatch.setattr(cuda_step, "control_step_cuda", refuse)
    monkeypatch.setattr(cuda_move, "launches", 0)
    qpos, qvel, ctrl = wall_states(6)
    ws = torch.zeros_like(qvel)
    seen = {}
    ref = cuda_move.control_step_walls_plain(qpos, qvel, ws, ctrl,
                                             MOVE05_PARAMS, frame_skip=2,
                                             contact_counts=seen)
    assert sum(int(v.sum()) for v in seen.values()) > 0
    for out in (cuda_move.control_step_walls(qpos, qvel, ws, ctrl,
                                             MOVE05_PARAMS, frame_skip=2),
                cuda_step.control_step(qpos, qvel, ws, ctrl, None,
                                       MOVE05_PARAMS, frame_skip=2)):
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_move.launches == 0
    # the walls matter: the flat-floor scene moves these states elsewhere
    flat = cuda_step.control_step(qpos, qvel, ws, ctrl, None,
                                  rc.ENV01_PARAMS, frame_skip=2)
    assert not torch.equal(flat[1], ref[1])


class FakeCudaTensor:
    """Stands for a CUDA tensor where there is no card: it has what the
    dispatch and the kernels' argument check read, and no data."""
    is_cuda = True
    device = torch.device("cuda:0")

    def __init__(self, *shape, dtype=torch.float32, contiguous=True):
        self.shape, self.dtype, self._contiguous = shape, dtype, contiguous

    def is_contiguous(self):
        return self._contiguous


def test_a_wall_scene_on_cuda_tensors_goes_to_k3(monkeypatch):
    """`cuda_step.control_step` dispatches by the scene and the device."""
    calls = []
    monkeypatch.setattr(cuda_move, "control_step_walls_cuda",
                        lambda *a, **k: calls.append("K3"))
    monkeypatch.setattr(cuda_step, "control_step_cuda",
                        lambda *a, **k: calls.append("K1"))
    x = FakeCudaTensor(2, 9)
    cuda_step.control_step(x, None, None, None, None, MOVE05_PARAMS)
    cuda_step.control_step(x, None, None, None, None, rc.ENV01_PARAMS)
    cuda_move.control_step_walls(x, None, None, None, MOVE05_PARAMS)
    assert calls == ["K3", "K1", "K3"]


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    cpu = [torch.zeros(2, 9), torch.zeros(2, 8), torch.zeros(2, 8),
           torch.zeros(2, 2)]
    with pytest.raises(ValueError, match="K3.*CUDA"):
        cuda_move.control_step_walls_cuda(*cpu, MOVE05_PARAMS)

    def args(**replaced):
        shapes = dict(qpos=(2, 9), qvel=(2, 8), ws=(2, 8), ctrl=(2, 2))
        out = {k: FakeCudaTensor(*v) for k, v in shapes.items()}
        out.update(replaced)
        return list(out.values())

    for bad, match in (
            (dict(qvel=FakeCudaTensor(2, 14)), "K3: qvel must have shape"),
            (dict(ctrl=FakeCudaTensor(3, 2)), "K3: ctrl must have shape"),
            (dict(ws=FakeCudaTensor(2, 8, dtype=torch.float64)),
             "K3: ws must be float32 or float64 like qpos"),
            (dict(qpos=FakeCudaTensor(2, 9, dtype=torch.float16)),
             "K3: qpos must be float32 or float64"),
            (dict(qvel=FakeCudaTensor(2, 8, contiguous=False)),
             "K3: qvel must be contiguous")):
        with pytest.raises(ValueError, match=match):
            cuda_move.control_step_walls_cuda(*args(**bad), MOVE05_PARAMS)
    five = rc.RobotSceneParams(walls=MOVE05_PARAMS.walls
                               + (MOVE05_PARAMS.walls[0],))
    with pytest.raises(ValueError, match="at most 4 walls"):
        cuda_move.control_step_walls_cuda(*args(), five)
    with pytest.raises(ValueError, match="K1 has no wall contacts"):
        cuda_step.control_step_cuda(*args(), None, MOVE05_PARAMS)
    assert cuda_move.launches == 0 and cuda_step.launches == 0


def test_move05_checkpoint_loads_at_its_own_width():
    """The outer policy the repo ships for EnvMove05-v1: 10-64-64-2."""
    net = mlp.from_numpy_params(checkpoint.load(
        ROOT / "models/EnvMove05-v1_PPO_r4/best_model.npz"), device="cpu")
    env = brt.make("EnvMove05-v1", device="cpu")
    _, obs = env.reset(5)
    assert obs.shape == (5, env.obs_dim) == (5, 10)
    mean, _, value = net(obs)
    assert mean.shape == (5, 2) and value.shape[0] == 5
    assert torch.isfinite(mean).all()
    assert net.policy_mean(obs).shape == (5, 2)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 9)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.control_step_cuda(x, torch.zeros(2, 8), torch.zeros(2, 8),
                                    torch.zeros(2, 2), None, rc.ENV01_PARAMS)
    assert cuda_step.launches == 0
    with pytest.raises(ValueError, match="K2.*CUDA"):
        cuda_block.control_step14_cuda(
            torch.zeros(2, 16), torch.zeros(2, 14), torch.zeros(2, 14),
            torch.zeros(2, 2), bs.ENV03_PARAMS)
    assert cuda_block.launches == 0


def test_kernel_module_imports_and_builds_lazily():
    """Importing the kernel module needs neither nvcc nor a GPU, and builds
    nothing; the kernel's struct mirrors the scene parameters."""
    code = ("import balance_robot_tpu_torch.physics.cuda_step as m; "
            "import balance_robot_tpu_torch.physics.cuda_block as m2; "
            "import balance_robot_tpu_torch.physics.cuda_move as m3; "
            "assert m._lib is None and m.launches == 0; "
            "assert m2._lib is None and m2.launches == 0; "
            "assert m3._lib is None and m3.launches == 0")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    p = cuda_step.kernel_params(fast_solver(rc.ENV02_PARAMS))
    assert p.timestep == rc.ENV02_PARAMS.timestep
    assert p.wheel.mu1 == 1.0 and p.chassis.invweight == \
        rc.ENV02_PARAMS.chassis_contact.invweight
    assert p.wheel.k == 1.0 / (0.95 * 0.95 * 0.02 * 0.02 * 1.0 * 1.0)
    p14 = cuda_block.kernel_params(fast_solver(bs.ENV03_PARAMS))
    assert p14.robot.wheel.mu1 == 1.0 and p14.block_mass == bs.BLOCK_MASS
    assert p14.block_wheel.invweight == bs.BLOCK_WHEEL.invweight
    assert p14.block_floor.k == 1.0 / (0.95 * 0.95 * 0.0125 * 0.0125
                                       * 0.95 * 0.95)
    assert p14.block_half == 0.02 and p14.block_margin == 0.002
    pw = cuda_move.kernel_params(fast_solver(MOVE05_PARAMS))
    assert pw.n_walls == 4 and pw.robot.wheel.mu1 == 0.9
    assert [list(w) for w in pw.walls] == [
        list(c) + list(h) for c, h in MOVE05_PARAMS.walls]
    # one wall_contact, two invweights: dA = 2 mu^2 (1 + mu^2) invweight
    assert pw.wall_chassis.invweight == 1.2709072512005732
    assert pw.wall_wheel.invweight == 3.3757186541109845
    assert pw.wall_chassis.dA1 == 4.0 * 1.2709072512005732
    assert pw.wall_wheel.dA2 == 4.0 * 3.3757186541109845
    assert pw.wall_wheel.k == pw.wall_chassis.k == 1.0 / (
        0.95 * 0.95 * 0.02 * 0.02 * 1.0 * 1.0)


@pytest.mark.cuda
def test_k1_matches_plain_on_the_card():
    """K1 against its plain version on the GPU (float64, a short control
    step, with and without friction) at B = 1 and at a ragged batch that
    is no multiple of the envs per block (when a block holds several)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K1)")
    g = torch.Generator().manual_seed(0)
    envs = cuda_step.launch_config(torch.float64)[1]   # per block
    for B in (1, 37):
        assert B == 1 or envs == 1 or B % envs
        qpos = torch.zeros(B, 9, dtype=torch.float64)
        qpos[:, 3] = 1.0
        qpos[:, 4] = torch.rand(B, generator=g, dtype=torch.float64) * 0.2
        qpos[:, 2] = -0.021
        qvel = torch.randn(B, 8, generator=g, dtype=torch.float64) * 0.3
        ctrl = torch.randn(B, 2, generator=g, dtype=torch.float64) * 5
        fric = torch.rand(B, generator=g, dtype=torch.float64) * 0.5 + 0.5
        for params in (rc.ENV01_PARAMS, fast_solver(rc.ENV02_PARAMS)):
            args = [t.cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
            fr = fric.cuda() if params.dynamic_friction else None
            before = cuda_step.launches
            out = cuda_step.control_step(*args, fr, params, frame_skip=20)
            assert cuda_step.launches == before + 1
            ref = cuda_step.control_step_plain(*args, fr, params,
                                               frame_skip=20)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    print(json.dumps(cuda_step.build_info["resources"]),
          cuda_step.launch_config(torch.float32),
          cuda_step.launch_config(torch.float64))


def block_states(B, seed=0):
    """chip_smoke.py's robot + block states in every contact regime, as
    float64 CPU tensors qpos (B,16), qvel (B,14), ctrl (B,2)."""
    import numpy as np
    import chip_smoke
    return tuple(torch.tensor(x) for x in chip_smoke.random_states14(
        np.random.default_rng(seed), B))


@pytest.mark.cuda
def test_k2_matches_plain_on_the_card():
    """K2 against its plain version on the GPU (float64, ragged batch, a
    short control step at both solver grades, every block contact kind
    active), and a float32 launch at the serving batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K2)")
    envs = cuda_block.launch_config(torch.float64)[1]   # per block
    for B in (1, 61):
        assert B == 1 or envs == 1 or B % envs
        qpos, qvel, ctrl = block_states(B)
        for params in (bs.ENV03_PARAMS, fast_solver(bs.ENV03_PARAMS)):
            args = [t.cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
            before = cuda_block.launches
            out = cuda_block.control_step14(*args, params, frame_skip=40)
            assert cuda_block.launches == before + 1
            seen = {}
            ref = cuda_block.control_step14_plain(*args, params,
                                                  frame_skip=40,
                                                  contact_counts=seen)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
            if B > 1:
                assert all(int(v.sum()) > 0 for v in seen.values()), seen
    print(json.dumps(cuda_block.build_info["resources"]),
          cuda_block.launch_config(torch.float32),
          cuda_block.launch_config(torch.float64))
    qpos, qvel, ctrl = block_states(4096, seed=1)
    args = [t.float().cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
    out = cuda_block.control_step14(*args, fast_solver(bs.ENV03_PARAMS))
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.cuda
def test_k3_matches_plain_on_the_card():
    """K3 against its plain version on the GPU (float64, a short control
    step at both solver grades) at B = 1, at a ragged batch and on each side
    of the crossover, so through both instantiations, with every wall
    contact kind active; a float32 launch at the main path's batch, and the
    refusals that need real CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K3)")
    from balance_robot_tpu_torch.physics import step as st
    X = cuda_move.crossover()
    team = cuda_move.launch_config(torch.float64, 1)[0]
    assert team > 1
    for B in (1, 61, X - 1, X + 1):
        assert cuda_move.launch_config(torch.float64, B)[0] == (
            team if B < X else 1)
        qpos, qvel, ctrl = wall_states(B)
        for params in (MOVE05_PARAMS, fast_solver(MOVE05_PARAMS)):
            args = [t.cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
            before = cuda_move.launches
            out = cuda_step.control_step(*args, None, params, frame_skip=40)
            assert cuda_move.launches == before + 1
            seen = {}
            ref = cuda_move.control_step_walls_plain(*args, params,
                                                     frame_skip=40,
                                                     contact_counts=seen)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
            if B > 1:
                assert set(seen) == set(st.WALL_CONTACT_KINDS)
                assert all(int(v.sum()) > 0 for v in seen.values()), seen
    print(json.dumps(cuda_move.build_info["resources"]),
          cuda_move.launch_config(torch.float32, 1),
          cuda_move.launch_config(torch.float32, X))
    with pytest.raises(ValueError, match="K3: qvel must have shape"):
        cuda_move.control_step_walls_cuda(args[0], args[0], args[2], args[3],
                                          MOVE05_PARAMS)
    with pytest.raises(ValueError, match="K3: ctrl must be float32 or"):
        cuda_move.control_step_walls_cuda(*args[:3], args[3].float(),
                                          MOVE05_PARAMS)
    qpos, qvel, ctrl = wall_states(4096, seed=1)
    args = [t.float().cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
    out = cuda_move.control_step_walls(*args, fast_solver(MOVE05_PARAMS))
    ref = cuda_move.control_step_walls_plain(*args,
                                             fast_solver(MOVE05_PARAMS))
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out)
    kind = torch.arange(4096) % 6
    for name, a, b in zip(("qpos", "qvel", "ws"), out, ref):
        d = (a - b).abs().max(1).values.cpu()
        print(name, "f32 drift by kind",
              [float(d[kind == i].max()) for i in range(6)])


@pytest.mark.cuda
def test_k3_checked_build_on_the_card(monkeypatch):
    """A checked build of K3 (-DBRT_CHECK_ROWS: every row-store index held
    to its range, the team's lanes to the same row count and state; a
    breach traps) runs a whole control step at the serving batch (the
    32-lane team) and above the crossover (one lane per env), in float32
    and float64, at both grades, with every wall contact kind active; two
    launches on the same inputs give the same bits, and float64 agrees
    with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K3)")
    import chip_smoke
    from balance_robot_tpu_torch.physics import kernel_build
    from balance_robot_tpu_torch.physics import step as st
    info = {}
    monkeypatch.setattr(cuda_move, "_lib", cuda_move._bind(kernel_build.build(
        "k3_checked", cuda_move.SOURCE, info,
        defines=("-DBRT_CHECK_ROWS",))))
    print(json.dumps(info["resources"]))
    X = cuda_move.crossover()
    for B in (512, X + 61):
        qpos, qvel, ctrl = wall_states(B, seed=2)
        for dtype in (torch.float32, torch.float64):
            args = [t.to("cuda", dtype) for t in (
                qpos, qvel, torch.zeros_like(qvel), ctrl)]
            for params in (MOVE05_PARAMS, fast_solver(MOVE05_PARAMS)):
                out = cuda_move.control_step_walls_cuda(*args, params)
                again = cuda_move.control_step_walls_cuda(*args, params)
                torch.cuda.synchronize()
                assert all(torch.isfinite(t).all() for t in out)
                assert all(torch.equal(a, b) for a, b in zip(out, again))
                if dtype == torch.float64:
                    seen = {}
                    ref = cuda_move.control_step_walls_plain(
                        *args, params, contact_counts=seen)
                    d = chip_smoke.drift(out, ref)
                    assert chip_smoke.within(d, chip_smoke.F64_TOL), (B, d)
                    assert set(seen) == set(st.WALL_CONTACT_KINDS)
                    assert all(int(v.sum()) > 0 for v in seen.values())


def _held_to_plain(kernel, plain, args, extra, dtype, tol32, **plain_kw):
    """Two launches of `kernel` give the same finite bits, and its output
    agrees with `plain` (called with `plain_kw`) within chip_smoke.F64_TOL
    in float64 and `tol32` in float32."""
    import chip_smoke
    out = kernel(*args, *extra)
    again = kernel(*args, *extra)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    d = chip_smoke.drift(out, plain(*args, *extra, **plain_kw))
    tol = chip_smoke.F64_TOL if dtype == torch.float64 else tol32
    assert chip_smoke.within(d, tol), (dtype, d)


@pytest.mark.cuda
def test_k1_checked_build_on_the_card(monkeypatch):
    """A checked build of K1 (-DBRT_CHECK_ROWS: every row-store index held
    to its range, the team's lanes to the same row count and state; a
    breach traps) runs a whole control step at Env01 serving's batch and at
    a ragged batch of the training rollout's size, on robot-floor states
    in every contact regime, in float32 and float64, at both grades and
    with per-env friction: two launches give the same bits, and the output
    agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K1)")
    import numpy as np
    import chip_smoke
    from balance_robot_tpu_torch.physics import kernel_build
    info = {}
    monkeypatch.setattr(cuda_step, "_lib", cuda_step._bind(kernel_build.build(
        "k1_checked", cuda_step.SOURCE, info,
        defines=("-DBRT_CHECK_ROWS",))))
    print(json.dumps(info["resources"]))
    for B in (256, 1031):
        qpos, qvel, ws, ctrl, fric = chip_smoke.random_states_np(
            np.random.default_rng(3), B)
        for dtype in (torch.float32, torch.float64):
            args = [torch.tensor(x, dtype=dtype, device="cuda")
                    for x in (qpos, qvel, ws, ctrl)]
            for params in (rc.ENV01_PARAMS, fast_solver(rc.ENV01_PARAMS),
                           fast_solver(rc.ENV02_PARAMS)):
                fr = (torch.tensor(fric, dtype=dtype, device="cuda")
                      if params.dynamic_friction else None)
                _held_to_plain(cuda_step.control_step_cuda,
                               cuda_step.control_step_plain, args,
                               (fr, params), dtype, chip_smoke.F32_TOL)


@pytest.mark.cuda
def test_k2_checked_build_on_the_card(monkeypatch):
    """A checked build of K2 (-DBRT_CHECK_ROWS) runs a whole control step
    on chip_smoke.py's robot + block states (block parked, in flight,
    hitting the chassis edge and the wheels: the 8x8 + 6x6 factorization
    while no robot-block row is active, the coupled 14x14 one where one
    is) at a ragged batch and at the flagship serving's batch, in float32
    and float64, at both grades: two launches give the same bits, the
    output agrees with the plain version, and every block collider was
    active."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K2)")
    import numpy as np
    import chip_smoke
    from balance_robot_tpu_torch.physics import kernel_build
    info = {}
    monkeypatch.setattr(cuda_block, "_lib", cuda_block._bind(
        kernel_build.build("k2_checked", cuda_block.SOURCE, info,
                           defines=("-DBRT_CHECK_ROWS",))))
    print(json.dumps(info["resources"]))
    for B in (257, 1024):
        qpos, qvel, ctrl = chip_smoke.random_states14(
            np.random.default_rng(4), B)
        for dtype in (torch.float32, torch.float64):
            args = [torch.tensor(x, dtype=dtype, device="cuda")
                    for x in (qpos, qvel, np.zeros_like(qvel), ctrl)]
            for params in (bs.ENV03_PARAMS, fast_solver(bs.ENV03_PARAMS)):
                seen = {}
                _held_to_plain(cuda_block.control_step14_cuda,
                               cuda_block.control_step14_plain, args,
                               (params,), dtype, chip_smoke.K2_F32_TOL,
                               contact_counts=seen)
                assert all(int(v.sum()) > 0 for v in seen.values()), seen
