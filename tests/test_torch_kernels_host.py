"""The CUDA kernels' own arithmetic, run on the host (no GPU, no nvcc).

Each kernel source (`csrc/*.cu`) is templated on its scalar type and also
compiles as plain C++; its `k*_count_ops` entry point runs the kernel's
code for one env in double, on a scalar that counts operations. Here that
host build is compared with the kernel's plain PyTorch version in float64,
on contact-rich states, over a short control step: the same arithmetic in
another order, so they agree to rounding (1e-9 leaves room for the
substeps; the warm start, qacc up to ~1e4, is compared relative to its
scale). A wrong kernel is caught before any GPU time.

Also checked: the build's content hash covers every header a kernel
includes, so an edit to a shared header rebuilds every kernel that includes
it.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from balance_robot_tpu_torch.envs.move import MOVE05_PARAMS
from balance_robot_tpu_torch.physics import block_step as bs
from balance_robot_tpu_torch.physics import cuda_block, cuda_move, cuda_step
from balance_robot_tpu_torch.physics import fast_solver, kernel_build
from balance_robot_tpu_torch.physics import robot_core as rc
from balance_robot_tpu_torch.physics import step as st

torch.set_num_threads(1)
F64 = torch.float64
FRAME_SKIP = 12
TOL = 1e-9
KERNELS = (cuda_step, cuda_block, cuda_move)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The kernel sources compiled as plain C++ with g++ and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to compile the kernel sources")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for mod in KERNELS:
        so = out / f"{mod.LABEL}.so"
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                        "-fPIC", "-o", str(so),
                        str(kernel_build.CSRC / mod.SOURCE)], check=True)
        libs[mod.LABEL] = mod._bind(so)
    return libs


def assert_state_close(host, plain):
    for a, b, name in zip(host[:2], plain[:2], ("qpos", "qvel")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
    scale = max(1.0, float(plain[2].abs().max()))
    np.testing.assert_allclose(host[2] / scale, plain[2] / scale, rtol=0,
                               atol=TOL, err_msg="warm start")


@pytest.mark.parametrize("scene,fast", [("Env01", False), ("Env02", True)])
def test_k1_host_build_matches_plain(host_libs, scene, fast):
    params = rc.ENV01_PARAMS if scene == "Env01" else rc.ENV02_PARAMS
    params = fast_solver(params) if fast else params
    B = 6
    rng = np.random.default_rng(1)
    qpos, qvel, ws, ctrl, fric = (
        torch.tensor(x) for x in chip_smoke.random_states_np(rng, B))
    fr = fric if params.dynamic_friction else None
    counts, *host = cuda_step.count_ops(qpos, qvel, ws, ctrl, fr, params,
                                        frame_skip=FRAME_SKIP,
                                        lib=host_libs["k1"])
    plain = cuda_step.control_step_plain(qpos, qvel, ws, ctrl, fr, params,
                                         frame_skip=FRAME_SKIP)
    assert_state_close(host, plain)
    # every env did FRAME_SKIP substeps of ~60k (fast) / ~125k (exact) ops
    per_substep = np.array(counts) / FRAME_SKIP
    assert (per_substep > 4e4).all() and (per_substep < 2e5).all()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_k2_host_build_matches_plain(host_libs, fast):
    params = fast_solver(bs.ENV03_PARAMS) if fast else bs.ENV03_PARAMS
    B = 12
    rng = np.random.default_rng(2)
    qpos, qvel, ctrl = (torch.tensor(x)
                        for x in chip_smoke.random_states14(rng, B))
    ws = torch.zeros(B, 14, dtype=F64)
    counts, *host = cuda_block.count_ops(qpos, qvel, ws, ctrl, params,
                                         frame_skip=FRAME_SKIP,
                                         lib=host_libs["k2"])
    seen = {}
    plain = cuda_block.control_step14_plain(qpos, qvel, ws, ctrl, params,
                                            frame_skip=FRAME_SKIP,
                                            contact_counts=seen)
    assert_state_close(host, plain)
    # the comparison reached every block collider
    assert all(int(v.sum()) > 0 for v in seen.values()), seen
    assert min(counts) > 0


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_k3_host_build_matches_plain(host_libs, fast):
    params = fast_solver(MOVE05_PARAMS) if fast else MOVE05_PARAMS
    B = 24
    rng = np.random.default_rng(3)
    qpos, qvel, ctrl = (torch.tensor(x)
                        for x in chip_smoke.random_states_walls(rng, B))
    ws = torch.zeros(B, 8, dtype=F64)
    counts, *host = cuda_move.count_ops(qpos, qvel, ws, ctrl, params,
                                        frame_skip=FRAME_SKIP,
                                        lib=host_libs["k3"])
    seen = {}
    plain = cuda_move.control_step_walls_plain(qpos, qvel, ws, ctrl, params,
                                               frame_skip=FRAME_SKIP,
                                               contact_counts=seen)
    assert_state_close(host, plain)
    # the comparison reached every wall collider: face, edge, wheel, a whole
    # face flush on the wall, two walls at once
    assert set(seen) == set(st.WALL_CONTACT_KINDS)
    assert all(int(v.sum()) > 0 for v in seen.values()), seen
    # only included contacts are stored, so K3 does fewer operations on
    # these states than K1 on its 64 masked rows (~60k fast / ~125k exact)
    per_substep = np.array(counts) / FRAME_SKIP
    assert (per_substep > 1e4).all() and (per_substep < 1.25e5).all()


def test_a_header_edit_changes_both_kernels_hashes(tmp_path, monkeypatch):
    names = {mod.LABEL: [p.name for p in kernel_build.sources(mod.SOURCE)]
             for mod in KERNELS}
    assert names["k1"] == ["control_step.cu", "robot_common.cuh"]
    assert names["k2"] == ["control_step14.cu", "box_collide.cuh",
                           "robot_common.cuh"]
    assert names["k3"] == ["control_step_walls.cu", "box_collide.cuh",
                           "robot_common.cuh"]

    def tags():
        return {m.LABEL: kernel_build.source_tag(m.SOURCE) for m in KERNELS}

    before = tags()
    for path in kernel_build.CSRC.iterdir():
        shutil.copy(path, tmp_path)
    monkeypatch.setattr(kernel_build, "CSRC", tmp_path)
    assert before == tags()
    with open(tmp_path / "robot_common.cuh", "a") as f:
        f.write("// edited\n")
    after = tags()
    assert all(after[k] != before[k] for k in ("k1", "k2", "k3"))
    with open(tmp_path / "box_collide.cuh", "a") as f:
        f.write("// edited\n")
    last = tags()
    assert last["k1"] == after["k1"]
    assert last["k2"] != after["k2"] and last["k3"] != after["k3"]
