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
it; the host build's section counters (`k*_count_ops_sections`) cover the
count and the plain version's rows; a wrapper takes the timed launch
only under `torch.profiler`, whose counters `profiling.counters()` folds;
the host builds' operation counts stay what they were before the teams
shared the factorization (the frozen work of the rooflines); and the team
factorization itself, run by host threads standing for the lanes, gives
the serial code's bits.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from balance_robot_tpu_torch.envs.move import MOVE05_PARAMS
from balance_robot_tpu_torch.physics import block_step as bs
from balance_robot_tpu_torch.physics import cuda_block, cuda_kernel
from balance_robot_tpu_torch.physics import cuda_move, cuda_step
from balance_robot_tpu_torch.physics import fast_solver, kernel_build
from balance_robot_tpu_torch.physics import robot_core as rc
from balance_robot_tpu_torch.physics import solver as sv
from balance_robot_tpu_torch.physics import step as st
from balance_robot_tpu_torch.utils import profiling

torch.set_num_threads(1)
F64 = torch.float64
FRAME_SKIP = 12
TOL = 1e-9
KERNELS = (cuda_step, cuda_block, cuda_move)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The kernel sources compiled as plain C++ with g++ and bound, as
    checked builds: a row index out of its range aborts."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to compile the kernel sources")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for mod in KERNELS:
        so = out / f"{mod.LABEL}.so"
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                        "-fPIC", "-DBRT_CHECK_ROWS", "-o", str(so),
                        str(kernel_build.CSRC / mod.SOURCE)], check=True)
        libs[mod.LABEL] = mod.KERNEL.bind(so)
    return libs


def assert_state_close(host, plain):
    for a, b, name in zip(host[:2], plain[:2], ("qpos", "qvel")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
    scale = max(1.0, float(plain[2].abs().max()))
    np.testing.assert_allclose(host[2] / scale, plain[2] / scale, rtol=0,
                               atol=TOL, err_msg="warm start")


class TeamRowsLib:
    """A host library whose k*_count_ops (`label`: k1 or k3) runs on the
    row store of the team instantiation (TeamRows, the by-entry solver)
    instead of the one-lane one (LaneRows, the one-pass solver)."""

    def __init__(self, lib, label):
        self.lib = lib
        setattr(self, f"{label}_count_ops",
                getattr(lib, f"{label}_count_ops_team_rows"))

    def __getattr__(self, name):
        return getattr(self.lib, name)


@pytest.mark.parametrize("scene,fast", [("Env01", False), ("Env02", True)])
def test_k1_host_build_matches_plain(host_libs, scene, fast):
    params = rc.ENV01_PARAMS if scene == "Env01" else rc.ENV02_PARAMS
    params = fast_solver(params) if fast else params
    B = 6
    rng = np.random.default_rng(1)
    qpos, qvel, ws, ctrl, fric = (
        torch.tensor(x) for x in chip_smoke.random_states_np(rng, B))
    fr = fric if params.dynamic_friction else None
    plain = cuda_step.control_step_plain(qpos, qvel, ws, ctrl, fr, params,
                                         frame_skip=FRAME_SKIP)
    # both row stores and their solver code, as a team of one lane: the
    # one-lane instantiation's (LaneRows, one pass per row: k1_count_ops)
    # and the team instantiation's (TeamRows, by entry, as the team's lanes
    # run it: k1_count_ops_team_rows)
    lib = host_libs["k1"]
    runs = [cuda_step.count_ops(qpos, qvel, ws, ctrl, fr, params,
                                frame_skip=FRAME_SKIP, lib=lb)
            for lb in (lib, TeamRowsLib(lib, "k1"))]
    for counts, *host in runs:
        assert_state_close(host, plain)
        # every env did FRAME_SKIP substeps. K1 keeps only included
        # contacts' rows (8-48 of the 64 on these states), so a substep is
        # ~14-31k (fast) / ~30-72k (exact) ops; with all 64 masked rows kept
        # it was ~60k / ~125k whatever the contacts
        per_substep = np.array(counts) / FRAME_SKIP
        assert (per_substep > 1e4).all() and (per_substep < 8e4).all()
    # the one pass takes the same operations in the same order as the
    # by-entry code: the same bits and the same count
    (c_lane, *lane), (c_team, *team) = runs
    assert c_lane == c_team
    assert all(torch.equal(a, b) for a, b in zip(lane, team))


def test_floor_rows_see_a_candidate_cross_the_floor():
    """chip_smoke.floor_rows, with which phase 6 finds a floor row that one
    version's last substep includes and the other's does not: the robot
    lowered until its lowest candidate lies 1e-9 m above the floor, then
    1e-9 m below, includes that candidate's 4 rows on one side only."""
    from balance_robot_tpu_torch.physics import contacts as ct
    B = 3
    qpos, qvel, ws, _, _ = (torch.tensor(x) for x in
                            chip_smoke.random_states_np(
                                np.random.default_rng(4), B))
    dist = ct.robot_floor_contacts(rc.fk(qpos)).dist            # (B, 16)
    low, lowest = dist.min(1)

    def at(height):
        q = qpos.clone()
        q[:, 2] += height - low
        return q

    above, _ = chip_smoke.floor_rows(at(1e-9), qvel, ws, rc.ENV01_PARAMS)
    below, _ = chip_smoke.floor_rows(at(-1e-9), qvel, ws, rc.ENV01_PARAMS)
    for i in range(B):
        flipped = (above[i] != below[i]).nonzero().flatten().tolist()
        assert flipped == [4 * int(lowest[i]) + r for r in range(4)]
        assert not above[i].any()


@pytest.mark.parametrize("gravity", [1.0, 1.5], ids=["plain", "heavier"])
def test_k1_warm_start_hold_sets_aside_only_row_flips(gravity):
    """chip_smoke.hold_k1_warm_start on the host, with a plain version in
    float64 standing in for the kernel: the plain version itself is held
    and nothing set aside; one under 1.5 g departs in its warm start on
    every env and is refused (no row flip explains it, or the plain
    version in float64 on its own state does not repeat it)."""
    B, frame_skip = 4, 3
    params = fast_solver(rc.ENV01_PARAMS)
    qpos, qvel, ws, ctrl, _ = (torch.tensor(x) for x in
                               chip_smoke.random_states_np(
                                   np.random.default_rng(6), B))
    other = params if gravity == 1.0 else replace(
        params, gravity=tuple(gravity * g for g in params.gravity))

    def kernel(q, v, w, c, f, p, frame_skip=250):
        return cuda_step.control_step_plain(q, v, w, c, f, other,
                                            frame_skip=frame_skip)

    args = (qpos, qvel, ws, ctrl, None, params)
    k_out = kernel(*args, frame_skip=frame_skip)
    p_out = cuda_step.control_step_plain(*args, frame_skip=frame_skip)
    if gravity == 1.0:
        assert chip_smoke.hold_k1_warm_start(
            kernel, cuda_step.control_step_plain, args, k_out, p_out,
            chip_smoke.F32_TOL, frame_skip) == (0.0, [])
        return
    assert chip_smoke.drift(k_out, p_out)["ws_rel"] \
        > chip_smoke.F32_TOL["ws_rel"]
    with pytest.raises(SystemExit):
        chip_smoke.hold_k1_warm_start(
            kernel, cuda_step.control_step_plain, args, k_out, p_out,
            chip_smoke.F32_TOL, frame_skip)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_k2_host_build_matches_plain(host_libs, fast):
    params = fast_solver(bs.ENV03_PARAMS) if fast else bs.ENV03_PARAMS
    B = 12
    rng = np.random.default_rng(2)
    qpos, qvel, ctrl = (torch.tensor(x)
                        for x in chip_smoke.random_states14(rng, B))
    ws = torch.zeros(B, 14, dtype=F64)
    coupled = []
    counts, *host = cuda_block.count_ops(qpos, qvel, ws, ctrl, params,
                                         frame_skip=FRAME_SKIP,
                                         lib=host_libs["k2"], coupled=coupled)
    seen = {}
    plain = cuda_block.control_step14_plain(qpos, qvel, ws, ctrl, params,
                                            frame_skip=FRAME_SKIP,
                                            contact_counts=seen)
    assert_state_close(host, plain)
    # the comparison reached every block collider
    assert all(int(v.sum()) > 0 for v in seen.values()), seen
    assert min(counts) > 0
    # and both ways of factorizing the Newton Hessian: 14 x 14 in envs with
    # an active robot-block row, 8 x 8 and 6 x 6 in envs without one
    coupled = np.array(coupled)
    assert (coupled > 0).any() and (coupled == 0).any(), coupled


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_k3_host_build_matches_plain(host_libs, fast):
    params = fast_solver(MOVE05_PARAMS) if fast else MOVE05_PARAMS
    B = 24
    rng = np.random.default_rng(3)
    qpos, qvel, ctrl = (torch.tensor(x)
                        for x in chip_smoke.random_states_walls(rng, B))
    ws = torch.zeros(B, 8, dtype=F64)
    seen = {}
    plain = cuda_move.control_step_walls_plain(qpos, qvel, ws, ctrl, params,
                                               frame_skip=FRAME_SKIP,
                                               contact_counts=seen)
    # the comparison reached every wall collider: face, edge, wheel, a whole
    # face flush on the wall, two walls at once
    assert set(seen) == set(st.WALL_CONTACT_KINDS)
    assert all(int(v.sum()) > 0 for v in seen.values()), seen
    # both row stores and their solver code, as a team of one lane: the
    # one-lane instantiation's (LaneRows, one pass per row) and the team
    # instantiation's (TeamRows, by entry, as the team's lanes run it)
    lib = host_libs["k3"]
    runs = [cuda_move.count_ops(qpos, qvel, ws, ctrl, params,
                                frame_skip=FRAME_SKIP, lib=lb)
            for lb in (lib, TeamRowsLib(lib, "k3"))]
    for counts, *host in runs:
        assert_state_close(host, plain)
        # only included contacts are stored, so K3 does fewer operations on
        # these states than K1 on its 64 masked rows (~60k fast / ~125k
        # exact): on the team solver ~12-35k fast / ~15-62k exact
        per_substep = np.array(counts) / FRAME_SKIP
        assert (per_substep > 1e4).all() and (per_substep < 1.25e5).all()
    # the one pass takes the same operations in the same order as the
    # by-entry code: the same bits and the same count
    (c_lane, *lane), (c_team, *team) = runs
    assert c_lane == c_team
    assert all(torch.equal(a, b) for a, b in zip(lane, team))


# Each kernel's wrapper: its launch, the widths of its state and ctrl, the
# scene arguments after them, its rungs from the smallest batch up as (team,
# first batch), each a `.cu` header macro (BRT_<kernel>_<name>) or a value,
# the values per env of its team's row store (13 columns of 65 rows for
# K1, 19 of 121 for K2, 13 of 273 for K3, then the Hessian's and the
# gradient's entries), the bounds (lo, hi] of its crossovers, and the C
# entries of its host build.
WRAPPERS = {
    "K1": (cuda_step, "control_step_cuda", (9, 8, 8, 2),
           (None, rc.ENV01_PARAMS), (("TEAM", 1), (1, "CROSSOVER")),
           13 * 65 + 44, ((1024, 4096),),
           {"k1_crossover", "k1_launch_config", "k1_count_ops",
            "k1_count_ops_team_rows", "k1_count_ops_sections"}),
    "K2": (cuda_block, "control_step14_cuda", (16, 14, 14, 2),
           (bs.ENV03_PARAMS,),
           (("TEAM", 1), ("MID_TEAM", "MID"), (8, "CROSSOVER")),
           19 * 121 + 119, ((1, 1023), (1024, 1792)),
           {"k2_crossover", "k2_mid_crossover", "k2_launch_config",
            "k2_count_ops", "k2_count_ops_sections"}),
    "K3": (cuda_move, "control_step_walls_cuda", (9, 8, 8, 2),
           (MOVE05_PARAMS,), (("TEAM", 1), (1, "CROSSOVER")),
           13 * 273 + 44, ((512, 4096),),
           {"k3_crossover", "k3_launch_config", "k3_count_ops",
            "k3_count_ops_team_rows", "k3_count_ops_sections",
            "k3_max_walls"}),
}


def header_rungs(kernel):
    """[(team, first batch)] of `kernel`'s rungs, as its `.cu` header's
    macros give them."""
    mod, *_, rungs = WRAPPERS[kernel][:5]
    text = (kernel_build.CSRC / mod.SOURCE).read_text()
    macros = {name: int(v) for name, v in re.findall(
        rf"#define BRT_{kernel}_(\w+) (\d+)\n", text)}
    return [tuple(macros[x] if isinstance(x, str) else x for x in rung)
            for rung in rungs]


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_host_build_exports_the_c_interface_and_the_header_rungs(
        host_libs, kernel):
    """Each host build exports the same C entries as before the kernels
    shared their launch code (the launches and the loads are nvcc's only),
    and the count by section, and its crossovers, read from those entries,
    are the header's."""
    mod, *_, bounds, entries = WRAPPERS[kernel]
    so = host_libs[mod.LABEL]._name
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("no nm on this host to list the library's exports")
    listed = subprocess.run([nm, "-D", "--defined-only", so], check=True,
                            capture_output=True, text=True).stdout.split()
    assert {n for n in listed if re.fullmatch(r"k\d_\w+", n)} == entries
    rungs = header_rungs(kernel)
    crossovers = mod.KERNEL.crossovers(host_libs[mod.LABEL])
    assert crossovers == [first for _, first in rungs[1:]]
    assert all(lo < x <= hi for x, (lo, hi) in zip(crossovers, bounds))


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrapper_launches_the_instantiation_the_header_names(
        host_libs, monkeypatch, kernel):
    """A wrapper hands the launch the team that the library's
    k*_launch_config gives for the batch: the `.cu` header's small-batch
    team below its first crossover, and each later rung's team from its
    crossover on (K1 and K3 one lane per env, K2 its middle team and then
    its team of 8); the kernel's `launches_by_team` counts each launch
    under its team. The team keeps an env's rows in its slice of the
    block's shared memory, one lane in its own local array. K1's crossover
    lies above the CLI's training batch of 1,024 envs, so that the sharded
    runs (2 x 512, 4 x 256) take the instantiation of one process at
    1,024."""
    mod, launch, widths, scene, _, size, _, _ = WRAPPERS[kernel]
    lib = host_libs[mod.LABEL]
    rungs = header_rungs(kernel)
    assert [team for team, _ in rungs] == {
        "K1": [32, 1], "K2": [32, 16, 8], "K3": [32, 1]}[kernel]
    batches = sorted({1, 1024, 4096} | {b + d for _, b in rungs[1:]
                                        for d in (-1, 0)})
    teams = [[g for g, first in rungs if first <= B][-1] for B in batches]
    launched = []

    def record(*args):
        launched.append(args[-2])
        return 0

    class Lib:
        """The host library, with a launch that records its team."""
        def __getattr__(self, name):
            if name == f"{mod.LABEL}_control_step_f32":
                return record
            return getattr(lib, name)

    monkeypatch.setattr(mod.KERNEL, "lib", Lib())
    monkeypatch.setattr(mod.KERNEL, "launches", 0)
    monkeypatch.setattr(mod.KERNEL, "launches_by_team", {})
    monkeypatch.setattr(cuda_kernel, "check_kernel_args", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for B in batches:
        getattr(mod, launch)(*(torch.zeros(B, n) for n in widths), *scene)
    assert launched == [mod.KERNEL.launch_config(torch.float32, B, lib)[0]
                        for B in batches] == teams
    assert mod.KERNEL.launches == len(batches)
    assert mod.KERNEL.launches_by_team == {g: teams.count(g) for g in teams}
    for dtype, nbytes in ((torch.float32, 4), (torch.float64, 8)):
        for team, first in rungs:
            assert mod.KERNEL.launch_config(dtype, first, lib) == (
                team, 32 // team,
                0 if team == 1 else 32 // team * size * nbytes)
    assert mod.KERNEL.launch_config(torch.float32, 1, lib)[2] == {
        "K1": 3556, "K2": 9672, "K3": 14372}[kernel]


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


def test_a_variant_build_has_its_own_library(tmp_path):
    """Macros (-D) and another source directory name another library, so
    that `tools/time_kernels.py` can time builds side by side."""
    so, _ = kernel_build._library("k2", "control_step14.cu")
    team8, _ = kernel_build._library("k2", "control_step14.cu",
                                     defines=("-DBRT_K2_TEAM=8",))
    assert so != team8
    for path in kernel_build.CSRC.iterdir():
        shutil.copy(path, tmp_path)
    same, _ = kernel_build._library("k2", "control_step14.cu", csrc=tmp_path)
    assert same == so
    with open(tmp_path / "control_step14.cu", "a") as f:
        f.write("// an earlier design\n")
    other, _ = kernel_build._library("k2", "control_step14.cu", csrc=tmp_path)
    assert other != so
    assert kernel_build.sources("control_step14.cu", tmp_path)[0] == \
        tmp_path / "control_step14.cu"


# ------------------------------------------------------------ section counters

def host_case(kernel):
    """(count, plain, states, params) of the host tests' states of
    `kernel`'s scene: count(states, params, **kw) runs its host build
    (`count_ops`), plain(states, params, **kw) its plain version."""
    rng = np.random.default_rng(int(kernel[1]))
    if kernel == "K1":
        qpos, qvel, ws, ctrl, _ = (torch.tensor(x) for x in
                                   chip_smoke.random_states_np(rng, 6))
        return (lambda s, p, **kw: cuda_step.count_ops(*s, None, p, **kw),
                lambda s, p, **kw: cuda_step.control_step_plain(*s, None, p,
                                                                **kw),
                (qpos, qvel, ws, ctrl), rc.ENV01_PARAMS)
    if kernel == "K2":
        qpos, qvel, ctrl = (torch.tensor(x) for x in
                            chip_smoke.random_states14(rng, 12))
        return (lambda s, p, **kw: cuda_block.count_ops(*s, p, **kw),
                lambda s, p, **kw: cuda_block.control_step14_plain(*s, p,
                                                                   **kw),
                (qpos, qvel, torch.zeros(12, 14, dtype=F64), ctrl),
                bs.ENV03_PARAMS)
    qpos, qvel, ctrl = (torch.tensor(x) for x in
                        chip_smoke.random_states_walls(rng, 24))
    return (lambda s, p, **kw: cuda_move.count_ops(*s, p, **kw),
            lambda s, p, **kw: cuda_move.control_step_walls_plain(*s, p,
                                                                  **kw),
            (qpos, qvel, torch.zeros(24, 8, dtype=F64), ctrl), MOVE05_PARAMS)


def host_sections(host_libs, kernel, states, params, **kw):
    """(counts, {counter: n} per env) of `kernel`'s host build."""
    count, *_ = host_case(kernel)
    sections = []
    counts, *_ = count(states, params, frame_skip=FRAME_SKIP,
                       lib=host_libs[f"k{kernel[1]}"], sections=sections,
                       **kw)
    return counts, sections


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_host_sections_sum_to_the_count(host_libs, kernel):
    """The six sections' operations sum exactly to `k*_count_ops`' count,
    each section does some of them, and the coupled Newton steps are K2's
    `count_ops(coupled=[])` figure (none in K1 and K3)."""
    count, _, states, params = host_case(kernel)
    kw = {"coupled": []} if kernel == "K2" else {}
    counts, *state = count(states, params, frame_skip=FRAME_SKIP,
                           lib=host_libs[f"k{kernel[1]}"], **kw)
    again, sections = host_sections(host_libs, kernel, states, params)
    assert again == counts
    for n, sec in zip(counts, sections):
        assert sum(sec[s] for s in cuda_kernel.SECTIONS) == n
        assert all(sec[s] > 0 for s in cuda_kernel.SECTIONS), sec
    coupled = [sec["coupled"] for sec in sections]
    assert coupled == kw.get("coupled", [0] * len(counts))
    if kernel == "K2":
        assert any(coupled) and not all(coupled)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_host_sections_without_contact(host_libs, kernel):
    """States with the robot lifted 1 m clear of the floor (and of K3's
    walls, at the corridor's centre) and K2's block far from both build no
    row, and take the same operations in the Hessian and the line search
    whatever their pose and velocities."""
    _, _, states, params = host_case(kernel)
    qpos = states[0][:3].clone()
    qpos[:, 2] += 1.0
    if kernel == "K3":
        qpos[:, :2] = 0.0
    if kernel == "K2":
        qpos[:, 9:12] = torch.tensor([5.0, 5.0, 1.0], dtype=F64)
    lifted = (qpos, *(t[:3] for t in states[1:]))
    _, sections = host_sections(host_libs, kernel, lifted, params)
    assert [sec["rows"] for sec in sections] == [0, 0, 0]
    for name in ("hessian", "linesearch"):
        assert len({sec[name] for sec in sections}) == 1, (name, sections)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_host_rows_are_the_plain_versions(host_libs, kernel, monkeypatch):
    """The rows the host build counts over the substeps are those that
    the plain version builds on the same states: its rows included, summed
    over the substeps that its solver takes."""
    _, plain, states, params = host_case(kernel)
    built = []
    newton = sv.solve_newton

    def counting(a_init, a_smooth, M, rows, **kw):
        built.append((rows.mask > 0).sum(-1))
        return newton(a_init, a_smooth, M, rows, **kw)

    monkeypatch.setattr(sv, "solve_newton", counting)
    plain(states, params, frame_skip=FRAME_SKIP)
    monkeypatch.undo()
    assert len(built) == FRAME_SKIP
    _, sections = host_sections(host_libs, kernel, states, params)
    rows = [sec["rows"] for sec in sections]
    assert rows == torch.stack(built).sum(0).tolist()
    assert max(rows) > 0


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_the_timed_launch_runs_only_under_the_profiler(monkeypatch, kernel):
    """A wrapper launches the rung's timed entry, with the int64 counters of
    its batch size, only while a `torch.profiler` session records, and the
    untimed entry otherwise; `profiling.counters()` folds what the timed
    launches left in the counters (a fake library's launch writes them),
    and `profiling.clear()` zeroes them."""
    mod, launch, widths, scene, *_ = WRAPPERS[kernel]
    B, n = 3, len(cuda_kernel.COUNTERS)
    launched = []

    def untimed(*args):
        launched.append("untimed")
        return 0

    def timed(*args):
        # env i: i + 1 cycles in each section, 4 rows, one launch
        launched.append("timed")
        row = (ctypes.c_longlong * (B * n)).from_address(args[-3])
        for i in range(B):
            for s in range(len(cuda_kernel.SECTIONS)):
                row[n * i + s] += i + 1
            row[n * i + cuda_kernel.COUNTERS.index("rows")] += 4
            row[n * i + cuda_kernel.COUNTERS.index("launches")] += 1
        return 0

    class Lib:
        """A fake library: its launches record and count; one lane."""
        def __getattr__(self, name):
            return {f"{mod.LABEL}_control_step_f32": untimed,
                    f"{mod.LABEL}_control_step_timed_f32": timed}[name]

    monkeypatch.setattr(mod.KERNEL, "lib", Lib())
    monkeypatch.setattr(mod.KERNEL, "launch_config",
                        lambda dtype, B, lib=None: (1, 32, 0))
    monkeypatch.setattr(mod.KERNEL, "_counters", {})
    monkeypatch.setattr(mod.KERNEL, "launches", 0)
    monkeypatch.setattr(mod.KERNEL, "launches_by_team", {})
    monkeypatch.setattr(cuda_kernel, "check_kernel_args", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    profiling.clear()

    def step():
        getattr(mod, launch)(*(torch.zeros(B, w) for w in widths), *scene)

    step()
    # under inference mode, as the evals run: the counters can still be
    # zeroed outside it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            torch.inference_mode():
        step()
        step()
    step()
    assert launched == ["untimed", "timed", "timed", "untimed"]
    assert mod.KERNEL.launches == 4
    label = mod.LABEL
    found = profiling.counters()
    assert {k: v for k, v in found.items() if k.startswith(label)} == {
        **{f"{label}.cycles.{s}": 2 * (1 + 2 + 3)
           for s in cuda_kernel.SECTIONS},
        f"{label}.cycles.slowest_env": 2 * 3 * len(cuda_kernel.SECTIONS),
        f"{label}.envs": B, f"{label}.rows": 2 * 4 * B,
        f"{label}.coupled_steps": 0, f"{label}.timed_launches": 2}
    profiling.clear()
    assert not any(k.startswith(label) for k in profiling.counters())
    assert mod.KERNEL.sections() is None


# ------------------------------------------------- the work the bounds count

# The host builds' operation counts per env on `host_case`'s states over
# FRAME_SKIP substeps, on the row store of each kernel's team instantiation
# (K1's and K3's `*_count_ops_team_rows`, K2's only one), and K2's Newton
# steps that factorized the coupled 14 x 14: what the tree gave before the
# teams of K1, K2 and K3 shared the factorization out over their lanes. The
# host builds are teams of one lane, which keep the serial code, so these
# stay; the frozen work behind every roofline (perf_bench/work/) is theirs.
PINNED_OPS = {
    ("K1", "exact"): [363756, 849912, 836844, 363756, 413376, 858096],
    ("K1", "fast"): [192348, 415272, 408540, 192348, 214320, 419760],
    ("K2", "exact"): [1714836, 2483196, 355992, 156840, 480237, 577644,
                      740715, 1128441, 419127, 156840, 447432, 1049556],
    ("K2", "fast"): [888825, 1272780, 206424, 108072, 268173, 316188,
                     395595, 585753, 237303, 108072, 254088, 550704],
    ("K3", "exact"): [602088, 576552, 750288, 609372, 737916, 284592,
                      356705, 270684, 725784, 646068, 740292, 336420,
                      181500, 258144, 649392, 634584, 738312, 272052,
                      602088, 532860, 726048, 333624, 738444, 440076],
    ("K3", "fast"): [352344, 327672, 419904, 342348, 409260, 193824,
                     230609, 186252, 408072, 360168, 410580, 218004,
                     143724, 180048, 369696, 354888, 409656, 187620,
                     352344, 306156, 408336, 215208, 409788, 266364],
}
PINNED_COUPLED = {"exact": [96, 96, 0, 0, 0, 0, 0, 0, 0, 0, 96, 96],
                  "fast": [48, 48, 0, 0, 0, 0, 0, 0, 0, 0, 48, 48]}


@pytest.mark.parametrize("kernel,grade", sorted(PINNED_OPS))
def test_host_operation_counts_are_pinned(host_libs, kernel, grade):
    count, _, states, params = host_case(kernel)
    params = fast_solver(params) if grade == "fast" else params
    label = f"k{kernel[1]}"
    lib = host_libs[label]
    kw = {"coupled": []} if kernel == "K2" else {}
    if kernel != "K2":
        lib = TeamRowsLib(lib, label)
    counts, *_ = count(states, params, frame_skip=FRAME_SKIP, lib=lib, **kw)
    assert list(counts) == PINNED_OPS[kernel, grade]
    if kernel == "K2":
        assert kw["coupled"] == PINNED_COUPLED[grade]


@pytest.fixture(scope="module")
def team_factor(tmp_path_factory):
    """tests/team_factor_host.cpp built with g++: robot_common.cuh's team
    factorization on a team of threads, against the serial code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to compile the emulation")
    exe = tmp_path_factory.mktemp("team_factor") / "team_factor"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread",
                    "-I", str(kernel_build.CSRC), "-o", str(exe),
                    str(Path(__file__).with_name("team_factor_host.cpp"))],
                   check=True)
    return exe


@pytest.mark.parametrize("dtype", ["float", "double"])
@pytest.mark.parametrize("nv,team", [(14, 32), (14, 16), (14, 8), (8, 32)],
                         ids=["K2-32", "K2-16", "K2-8", "K1-32"])
def test_team_factorization_gives_the_serial_bits(team_factor, nv, team,
                                                  dtype):
    """The Newton step that a team's lanes factorize and solve together
    (`team_factor_solve`: a row of L per lane, the split blocks side by
    side) has the serial code's bits on every lane, split and coupled, in
    float and double: the same operations in the same order. Host threads
    stand for the lanes, so this holds the order, not the card's FMA
    contraction (the card tests hold that)."""
    run = subprocess.run([str(team_factor), str(nv), str(team), dtype],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stdout
    cases = 40 if nv == 8 else 80
    assert run.stdout.strip().endswith(
        f"{cases} cases, 0 entries differ"), run.stdout
