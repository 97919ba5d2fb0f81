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
from balance_robot_tpu_torch.physics import cuda_block, cuda_kernel
from balance_robot_tpu_torch.physics import cuda_move, cuda_step
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
            "mesh.py", "drift.py", "hardened.py", "selection.py",
            "burst.py", "sweep.py", "eval_policy.py"} <= {
                p.name for p in PORT_FILES}
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


def wall_states(B, seed=0):
    """chip_smoke.py's robot states in every wall-contact regime, as float64
    CPU tensors qpos (B,9), qvel (B,8), ctrl (B,2)."""
    import numpy as np
    import chip_smoke
    return tuple(torch.tensor(x) for x in chip_smoke.random_states_walls(
        np.random.default_rng(seed), B))


# each kernel's wrapper, its launch, the widths of its state and ctrl, and
# the scene arguments after them
KERNELS = {"K1": (cuda_step, "control_step_cuda", (9, 8, 8, 2),
                  (None, rc.ENV01_PARAMS)),
           "K2": (cuda_block, "control_step14_cuda", (16, 14, 14, 2),
                  (bs.ENV03_PARAMS,)),
           "K3": (cuda_move, "control_step_walls_cuda", (9, 8, 8, 2),
                  (MOVE05_PARAMS,))}


def cpu_case(kernel):
    """(the entries that take CPU tensors to `kernel`'s plain version, that
    version, their arguments) on float64 states of the kernel's scene: K1 on
    the floor, K2 and K3 in every contact regime of theirs."""
    if kernel == "K1":
        qpos = torch.zeros(3, 9, dtype=torch.float64)
        qpos[:, 3] = 1.0
        qpos[:, 2] = -0.021
        qvel = torch.zeros(3, 8, dtype=torch.float64)
        return ([cuda_step.control_step], cuda_step.control_step_plain,
                (qpos, qvel, qvel, torch.ones(3, 2, dtype=torch.float64),
                 None, rc.ENV01_PARAMS))
    if kernel == "K2":
        qpos, qvel, ctrl = block_states(6)
        return ([cuda_block.control_step14], cuda_block.control_step14_plain,
                (qpos, qvel, qvel, ctrl, bs.ENV03_PARAMS))
    qpos, qvel, ctrl = wall_states(6)
    # the envs' entry sends a wall scene to K3's wrapper
    return ([cuda_move.control_step_walls,
             lambda *a, **k: cuda_step.control_step(*a[:4], None, *a[4:],
                                                    **k)],
            cuda_move.control_step_walls_plain,
            (qpos, qvel, torch.zeros_like(qvel), ctrl, MOVE05_PARAMS))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cpu_tensors_take_the_plain_version(monkeypatch, kernel):
    """CPU tensors take the kernel's plain version through its wrapper (and,
    for a wall scene, through the envs' entry `cuda_step.control_step`),
    bit for bit, and launch no kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launched for CPU tensors")

    for mod, launch, _, _ in KERNELS.values():
        monkeypatch.setattr(mod, launch, refuse)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
    entries, plain, args = cpu_case(kernel)
    ref = plain(*args, frame_skip=2)
    for entry in entries:
        for a, b in zip(entry(*args, frame_skip=2), ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(m.KERNEL.launches == 0 for m, *_ in KERNELS.values())
    params = args[-1]
    if params.walls:
        # the walls matter: the states touch them, and the flat-floor scene
        # moves them elsewhere
        seen = {}
        plain(*args, frame_skip=2, contact_counts=seen)
        assert sum(int(v.sum()) for v in seen.values()) > 0
        flat = cuda_step.control_step(*args[:4], None, rc.ENV01_PARAMS,
                                      frame_skip=2)
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


# what each kernel's wrapper refuses of a scene: (scene arguments, error)
REFUSED_SCENES = {
    "K1": [((None, MOVE05_PARAMS), "K1 has no wall contacts")],
    "K2": [],
    "K3": [((rc.RobotSceneParams(walls=MOVE05_PARAMS.walls
                                 + (MOVE05_PARAMS.walls[0],)),),
            "at most 4 walls")]}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                              kernel):
    mod, launch, widths, scene = KERNELS[kernel]
    launch = getattr(mod, launch)
    monkeypatch.setattr(mod.KERNEL, "launches", 0)
    with pytest.raises(ValueError, match=f"{kernel}: qpos must be on .*CUDA"):
        launch(*(torch.zeros(2, n) for n in widths), *scene)

    def args(**replaced):
        out = {k: FakeCudaTensor(2, n)
               for k, n in zip(("qpos", "qvel", "ws", "ctrl"), widths)}
        out.update(replaced)
        return list(out.values())

    nq, nv = widths[:2]
    for bad, match in (
            (dict(qvel=FakeCudaTensor(2, nv + 6)), "qvel must have shape"),
            (dict(ctrl=FakeCudaTensor(3, 2)), "ctrl must have shape"),
            (dict(ws=FakeCudaTensor(2, nv, dtype=torch.float64)),
             "ws must be float32 or float64 like qpos"),
            (dict(qpos=FakeCudaTensor(2, nq, dtype=torch.float16)),
             "qpos must be float32 or float64"),
            (dict(qvel=FakeCudaTensor(2, nv, contiguous=False)),
             "qvel must be contiguous")):
        with pytest.raises(ValueError, match=f"{kernel}: {match}"):
            launch(*args(**bad), *scene)
    for refused, match in REFUSED_SCENES[kernel]:
        with pytest.raises(ValueError, match=match):
            launch(*args(), *refused)
    assert mod.KERNEL.launches == 0


def test_kernel_module_imports_and_builds_lazily():
    """Importing the kernel module needs neither nvcc nor a GPU, and builds
    nothing; the kernel's struct mirrors the scene parameters."""
    code = ("import balance_robot_tpu_torch.physics.cuda_step as m; "
            "import balance_robot_tpu_torch.physics.cuda_block as m2; "
            "import balance_robot_tpu_torch.physics.cuda_move as m3; "
            "assert m.KERNEL.lib is None and m.KERNEL.launches == 0; "
            "assert m2.KERNEL.lib is None and m2.KERNEL.launches == 0; "
            "assert m3.KERNEL.lib is None and m3.KERNEL.launches == 0")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    # the wrappers share cuda_kernel; no wrapper imports another at its top
    # (K1's entry imports K3's when it meets a wall scene)
    wrappers = {"cuda_step", "cuda_block", "cuda_move"}
    for name in wrappers:
        tree = ast.parse((ROOT / "balance_robot_tpu_torch" / "physics"
                          / f"{name}.py").read_text())
        assert not wrappers & {a.name for node in tree.body
                               if isinstance(node, ast.ImportFrom)
                               for a in node.names}, name
    p = cuda_kernel.kernel_params(fast_solver(rc.ENV02_PARAMS))
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
    step, with and without friction) at B = 1 and at ragged batches that
    are no multiple of the envs per block (when a block holds several),
    on each side of the crossover, so through both instantiations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K1)")
    g = torch.Generator().manual_seed(0)
    X, = cuda_step.KERNEL.crossovers()
    team = cuda_step.KERNEL.launch_config(torch.float64, 1)[0]
    assert team > 1
    for B in (1, 37, X - 3, X + 5):
        lanes, envs, _ = cuda_step.KERNEL.launch_config(torch.float64, B)
        assert lanes == (team if B < X else 1)
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
            before = cuda_step.KERNEL.launches
            out = cuda_step.control_step(*args, fr, params, frame_skip=20)
            assert cuda_step.KERNEL.launches == before + 1
            ref = cuda_step.control_step_plain(*args, fr, params,
                                               frame_skip=20)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    print(json.dumps(cuda_step.KERNEL.build_info["resources"]),
          *(cuda_step.KERNEL.launch_config(dtype, B)
            for dtype in (torch.float32, torch.float64) for B in (1, X)))


def block_states(B, seed=0):
    """chip_smoke.py's robot + block states in every contact regime, as
    float64 CPU tensors qpos (B,16), qvel (B,14), ctrl (B,2)."""
    import numpy as np
    import chip_smoke
    return tuple(torch.tensor(x) for x in chip_smoke.random_states14(
        np.random.default_rng(seed), B))


@pytest.mark.cuda
def test_k2_matches_plain_on_the_card():
    """K2 against its plain version on the GPU (float64, a short control
    step at both solver grades, every block contact kind active) at B = 1,
    at a ragged batch and on each side of both crossovers, so through all
    three instantiations, each of them at a ragged batch, each launch
    counted under its team; and a float32 launch at the main path's
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K2)")
    M, X = cuda_block.KERNEL.crossovers()
    team = cuda_block.KERNEL.launch_config(torch.float64, 1)[0]
    mid_team = cuda_block.KERNEL.launch_config(torch.float64, M)[0]
    assert team > mid_team > 8
    ragged = set()
    for B in (1, 61, M - 1, M, X - 1, X + 1):
        cfg = cuda_block.KERNEL.launch_config(torch.float64, B)
        assert cfg[0] == (team if B < M else mid_team if B < X else 8)
        if cfg[1] == 1 or B % cfg[1]:
            ragged.add(cfg[0])
        qpos, qvel, ctrl = block_states(B)
        for params in (bs.ENV03_PARAMS, fast_solver(bs.ENV03_PARAMS)):
            args = [t.cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
            before = cuda_block.KERNEL.launches
            by_team = cuda_block.KERNEL.launches_by_team.get(cfg[0], 0)
            out = cuda_block.control_step14(*args, params, frame_skip=40)
            assert cuda_block.KERNEL.launches == before + 1
            assert (cuda_block.KERNEL.launches_by_team[cfg[0]]
                    == by_team + 1)
            seen = {}
            ref = cuda_block.control_step14_plain(*args, params,
                                                  frame_skip=40,
                                                  contact_counts=seen)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
            if B > 1:
                assert all(int(v.sum()) > 0 for v in seen.values()), seen
    assert ragged == {team, mid_team, 8}
    print(json.dumps(cuda_block.KERNEL.build_info["resources"]),
          *(cuda_block.KERNEL.launch_config(torch.float32, B)
            for B in (1, M, X)))
    qpos, qvel, ctrl = block_states(4096, seed=1)
    args = [t.float().cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
    out = cuda_block.control_step14(*args, fast_solver(bs.ENV03_PARAMS))
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contact regimes", "mixed warps"])
def test_k2_bits_do_not_depend_on_the_batch(case):
    """Every instantiation of K2 takes its row sums as a team of 32 lanes
    would, and its team shares the Newton factorization out over its lanes
    in the serial code's order, so an env's control step gives the same
    bits at any batch: the first envs of a launch above the second
    crossover (the team of 8) and of one between the crossovers (the team
    of 16) against the same envs alone (the team of 32) and one env at B =
    1, in float32 and float64, at both grades, on states in every contact
    regime. Mixed warps: on other such states, a third of them with the
    block against the robot, launched under `torch.profiler` (the timed
    instantiation, whose bits are the untimed one's), the warps of the
    teams of 16 and 8 hold envs that take the coupled 14 x 14
    factorization beside envs that take the split one (by the section
    counters' coupled Newton steps), and each of the 61 first envs gives
    its bits alone at B = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K2)")
    M, X = cuda_block.KERNEL.crossovers()
    assert [cuda_block.KERNEL.launch_config(torch.float32, B)[0]
            for B in (61, M + 61, X + 61)] == [32, 16, 8]
    if case == "mixed warps":
        return _k2_mixed_warps(M, X)
    qpos, qvel, ctrl = block_states(X + 61, seed=5)
    for dtype in (torch.float32, torch.float64):
        args = [t.to("cuda", dtype) for t in (
            qpos, qvel, torch.zeros_like(qvel), ctrl)]
        for params in (bs.ENV03_PARAMS, fast_solver(bs.ENV03_PARAMS)):
            big = cuda_block.control_step14_cuda(*args, params)
            mid = cuda_block.control_step14_cuda(
                *(t[:M + 61].contiguous() for t in args), params)
            small = cuda_block.control_step14_cuda(
                *(t[:61].contiguous() for t in args), params)
            one = cuda_block.control_step14_cuda(
                *(t[37:38].contiguous() for t in args), params)
            torch.cuda.synchronize()
            for a, m, b, c in zip(big, mid, small, one):
                assert torch.equal(a[:61], b), (dtype, params.newton_iters)
                assert torch.equal(m[:61], b), (dtype, params.newton_iters)
                assert torch.equal(a[37:38], c)


def _k2_mixed_warps(M, X):
    K = cuda_block.KERNEL
    coupled_at = cuda_kernel.COUNTERS.index("coupled")
    cpu_only = [torch.profiler.ProfilerActivity.CPU]
    qpos, qvel, ctrl = block_states(X + 61, seed=7)
    for dtype in (torch.float32, torch.float64):
        args = [t.to("cuda", dtype) for t in (
            qpos, qvel, torch.zeros_like(qvel), ctrl)]
        for params in (bs.ENV03_PARAMS, fast_solver(bs.ENV03_PARAMS)):
            K.clear_sections()
            with torch.profiler.profile(activities=cpu_only):
                outs = [cuda_block.control_step14_cuda(
                    *(t[:B].contiguous() for t in args), params)
                    for B in (61, M + 61, X + 61)]
            torch.cuda.synchronize()
            rows = K.section_rows()
            assert K.sections()["total"]["coupled"] > 0
            for B, envs in ((M + 61, 2), (X + 61, 4)):
                steps = rows[B][:60, coupled_at].view(-1, envs)
                mixed = (steps.max(1).values > 0) & (steps.min(1).values == 0)
                assert mixed.any(), (dtype, B, steps.tolist())
            for i in range(61):
                one = cuda_block.control_step14_cuda(
                    *(t[i:i + 1].contiguous() for t in args), params)
                for out in outs:
                    for a, c in zip(out, one):
                        assert torch.equal(a[i:i + 1], c), (
                            dtype, params.newton_iters, i)


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
    X, = cuda_move.KERNEL.crossovers()
    team = cuda_move.KERNEL.launch_config(torch.float64, 1)[0]
    assert team > 1
    for B in (1, 61, X - 1, X + 1):
        assert cuda_move.KERNEL.launch_config(torch.float64, B)[0] == (
            team if B < X else 1)
        qpos, qvel, ctrl = wall_states(B)
        for params in (MOVE05_PARAMS, fast_solver(MOVE05_PARAMS)):
            args = [t.cuda() for t in (qpos, qvel, torch.zeros_like(qvel),
                                       ctrl)]
            before = cuda_move.KERNEL.launches
            out = cuda_step.control_step(*args, None, params, frame_skip=40)
            assert cuda_move.KERNEL.launches == before + 1
            seen = {}
            ref = cuda_move.control_step_walls_plain(*args, params,
                                                     frame_skip=40,
                                                     contact_counts=seen)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
            if B > 1:
                assert set(seen) == set(st.WALL_CONTACT_KINDS)
                assert all(int(v.sum()) > 0 for v in seen.values()), seen
    print(json.dumps(cuda_move.KERNEL.build_info["resources"]),
          cuda_move.KERNEL.launch_config(torch.float32, 1),
          cuda_move.KERNEL.launch_config(torch.float32, X))
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


def section_states(kernel, B):
    """chip_smoke.py's float64 states of `kernel`'s scene in every contact
    regime, as CPU tensors (qpos, qvel, ws, ctrl)."""
    import numpy as np
    import chip_smoke
    rng = np.random.default_rng(7)
    if kernel == "K1":
        return tuple(torch.tensor(x) for x in
                     chip_smoke.random_states_np(rng, B)[:4])
    make = {"K2": chip_smoke.random_states14,
            "K3": chip_smoke.random_states_walls}[kernel]
    qpos, qvel, ctrl = (torch.tensor(x) for x in make(rng, B))
    return qpos, qvel, torch.zeros_like(qvel), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_section_timers_on_the_card(kernel):
    """The section timers at B = 1, at each crossover - 1 and at 4096: a
    launch under `torch.profiler` (the timed instantiation) gives the bits
    of one without (the untimed), in float32 and float64; the rows that the
    float64 launch counts are the host build's on the same states (32
    envs); and the slowest env's summed cycles, over the SM clock that
    nvidia-smi reads while the float32 launches run, lie within 10% of a
    launch's CUDA-event time where the launch takes one wave: the six
    sections cover the chain. A launch of more waves than one (K2's team
    of 8 at 4096: its shared rows leave 5 blocks per SM) lasts longer than
    any one env's chain, but not `waves` times longer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    import numpy as np
    import chip_smoke
    from balance_robot_tpu_torch.utils import profiling
    mod, launch, _, scene = KERNELS[kernel]
    K = mod.KERNEL
    cpu_only = [torch.profiler.ProfilerActivity.CPU]
    rows_at = cuda_kernel.COUNTERS.index("rows")

    def step(args):
        return getattr(mod, launch)(*args, *scene)

    for B in sorted({1, 4096} | {x - 1 for x in K.crossovers()}):
        states = section_states(kernel, B)
        for dtype in (torch.float32, torch.float64):
            args = [t.to("cuda", dtype) for t in states]
            K.clear_sections()
            untimed = step(args)
            assert not profiling.recording()
            with torch.profiler.profile(activities=cpu_only):
                timed = step(args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(untimed, timed)), \
                (B, dtype)
        sample = torch.linspace(0, B - 1, min(B, 32)).long().unique()
        host = []
        mod.count_ops(*(t[sample] for t in states), *scene, sections=host)
        assert K.section_rows()[B][sample, rows_at].tolist() == [
            h["rows"] for h in host], B
        args = [t.to("cuda", torch.float32) for t in states]
        K.clear_sections()
        with torch.profiler.profile(activities=cpu_only):
            once = chip_smoke.time_kernel(lambda: step(args))
            n = max(5, int(np.ceil(400.0 / once)))
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(n + 1)]
            events[0].record()
            for e in events[1:]:
                step(args)
                e.record()
            mhz = float(chip_smoke.nvidia_smi("clocks.sm",
                                              "csv,noheader,nounits"))
            torch.cuda.synchronize()
        found = K.sections()
        assert found["launches"] == chip_smoke.TIMED_LAUNCHES + n
        ms = float(np.median([a.elapsed_time(b)
                              for a, b in zip(events, events[1:])]))
        slowest = sum(found["slowest_env"][s] for s in cuda_kernel.SECTIONS)
        covered = slowest / found["launches"] / (mhz * 1e3) / ms
        waves = K.waves(torch.float32, B)
        print(f"{kernel} B={B}: {ms:.3f} ms per launch ({waves} waves), the "
              f"slowest env's sections {covered:.3f} of it at {mhz:.0f} MHz")
        assert 1.0 / waves - 0.1 <= covered <= 1.1, (B, waves, covered)
        assert waves > 1 or covered >= 0.9, (B, covered)


def use_checked_build(monkeypatch, mod):
    """Launch the checked build (-DBRT_CHECK_ROWS) of `mod`'s kernel for the
    rest of the test; print its ptxas resources."""
    from balance_robot_tpu_torch.physics import kernel_build
    info = {}
    monkeypatch.setattr(mod.KERNEL, "lib", mod.KERNEL.bind(
        kernel_build.build(f"{mod.LABEL}_checked", mod.SOURCE, info,
                           defines=("-DBRT_CHECK_ROWS",))))
    print(json.dumps(info["resources"]))


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
    from balance_robot_tpu_torch.physics import step as st
    use_checked_build(monkeypatch, cuda_move)
    X, = cuda_move.KERNEL.crossovers()
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
    a ragged batch of the training rollout's size (the team of 32), and at
    a ragged batch above the crossover (one lane per env), on robot-floor
    states in every contact regime, in float32 and float64, at both grades
    and with per-env friction: two launches give the same bits, and the
    output agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K1)")
    import numpy as np
    import chip_smoke
    use_checked_build(monkeypatch, cuda_step)
    X, = cuda_step.KERNEL.crossovers()
    assert [cuda_step.KERNEL.launch_config(torch.float32, B)[0]
            for B in (256, 1031, X + 61)] == [32, 32, 1]
    for B in (256, 1031, X + 61):
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
    is) at the eval's batch (the team of 32), at the flagship serving's
    (the team of 16) and at a ragged batch above the second crossover (the
    team of 8), in float32 and float64, at both grades: two launches give
    the same bits, the output agrees with the plain version, and every
    block collider was active."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K2)")
    import numpy as np
    import chip_smoke
    use_checked_build(monkeypatch, cuda_block)
    _, X = cuda_block.KERNEL.crossovers()
    assert [cuda_block.KERNEL.launch_config(torch.float32, B)[0]
            for B in (512, 1024, X + 61)] == [32, 16, 8]
    for B in (512, 1024, X + 61):
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
