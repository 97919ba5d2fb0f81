"""The port's 14-dof robot + block physics against the JAX package (CPU).

Same inputs (numpy, from a seed) through both packages, in float64: the
box-box and box-cylinder colliders, the general-frame constraint rows, one
substep at both solver grades, and a full 250-substep control step through
a block impact (the plain version of kernel K2 against the JAX package's
XLA array path, which its own tests hold the Pallas kernel to). The two
sides run the same formulas in another operation order, so they agree to
rounding: ~1e-15 after one substep, and the bounds below leave room for 250
substeps of it through stiff contacts. The warm start is qacc, up to ~1e4,
so it is compared relative to its scale.

The interpret-mode Pallas kernel is not run here: tracing its scalar
substep takes minutes on the CPU (the JAX package marks those tests slow).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from balance_robot_tpu.physics import block_step as jbs
from balance_robot_tpu.physics import box_collisions as jbc
from balance_robot_tpu.physics import fast_solver as jfast_solver

from balance_robot_tpu_torch.physics import block_step as bs
from balance_robot_tpu_torch.physics import box_collisions as bc
from balance_robot_tpu_torch.physics import contacts as ct
from balance_robot_tpu_torch.physics import cuda_block
from balance_robot_tpu_torch.physics import fast_solver
from balance_robot_tpu_torch.physics import robot_core as rc
from balance_robot_tpu_torch.physics import rows as rw

torch.set_num_threads(1)
F64 = torch.float64
CHASSIS_HALF = (0.05, 0.0185, 0.0855)
MARGIN = 0.002


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def T(x):
    return torch.tensor(np.asarray(x, np.float64), dtype=F64)


def rot(euler):
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("xyz", euler).as_matrix()


def included(pos, dist, inc):
    """Sorted (dist, pos) rows of the included candidates."""
    rows = [(float(d), *map(float, p)) for p, d, i in zip(pos, dist, inc)
            if i]
    return np.array(sorted(rows)).reshape(-1, 4)


# ------------------------------------------------------------ colliders

def box_box_configs():
    """(name, c1, R1, c2, R2, half2): the block pressed into the rotated
    chassis top face (the JAX package's own collider test), flush aligned
    faces (every SAT and rank tie at once), and edge-edge crossings at a
    vertical chassis edge."""
    out = []
    rng = np.random.default_rng(3)
    small = (0.01, 0.01, 0.01)
    for k in range(12):
        R1 = rot(rng.normal(size=3) * 0.4)
        local = np.array([rng.normal() * 0.02, rng.normal() * 0.008,
                          0.0855 + rng.uniform(-0.004, 0.012)])
        out.append((f"top{k}", np.zeros(3), R1, R1 @ local,
                    rot(rng.normal(size=3)), small))
    for k, depth in enumerate((0.0, 0.001, -0.0015)):
        R1 = rot(rng.normal(size=3) * 0.3) if k else np.eye(3)
        local = np.array([0.01 * k, 0.0, 0.0855 + 0.02 - depth])
        out.append((f"flush{k}", np.zeros(3), R1, R1 @ local, R1.copy(),
                    bs.BLOCK_HALF))
    for k in range(6):
        gap = rng.uniform(0.012, 0.018)
        c2 = np.array([0.05 + gap, (0.0185 + gap) * (-1) ** k,
                       rng.uniform(-0.05, 0.05)])
        out.append((f"edge{k}", np.zeros(3), np.eye(3), c2,
                    rot(rng.normal(size=3)), bs.BLOCK_HALF))
    return out


@functools.lru_cache(maxsize=None)
def _jax_box_box(half2):
    return jax.jit(lambda c1, R1, c2, R2: jbc.box_box(
        c1, R1, CHASSIS_HALF, c2, R2, half2, MARGIN))


def test_box_box_matches_jax(x64):
    cfgs = box_box_configs()
    n_face = n_edge = 0
    for half2 in sorted({c[5] for c in cfgs}):
        group = [c for c in cfgs if c[5] == half2]
        c1, R1, c2, R2 = (np.stack([c[i] for c in group]) for i in (1, 2, 3,
                                                                    4))
        mine = bc.box_box(T(c1), T(R1), CHASSIS_HALF, T(c2), T(R2), half2,
                          MARGIN)
        for i, cfg in enumerate(group):
            ref = _jax_box_box(half2)(*(jnp.asarray(x[i])
                                        for x in (c1, R1, c2, R2)))
            np.testing.assert_array_equal(mine.include[i], ref.include,
                                          err_msg=cfg[0])
            a = included(mine.pos[i].numpy(), mine.dist[i].numpy(),
                         mine.include[i].numpy())
            b = included(np.asarray(ref.pos), np.asarray(ref.dist),
                         np.asarray(ref.include))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12,
                                       err_msg=cfg[0])
            inc = np.asarray(ref.include)
            np.testing.assert_allclose(mine.frame[i].numpy()[inc],
                                       np.asarray(ref.frame)[inc], rtol=0,
                                       atol=1e-12, err_msg=cfg[0])
            n_face += bool(inc[:8].any())
            n_edge += bool(inc[8])
    # the draw must exercise both manifolds
    assert n_face >= 8 and n_edge >= 3, (n_face, n_edge)


def test_box_cylinder_matches_jax(x64):
    half = (0.01, 0.01, 0.01)
    r, h = 0.034, 0.013
    jfn = jax.jit(lambda cbox, Rbox, ccyl, axis: jbc.box_cylinder(
        cbox, Rbox, half, ccyl, axis, r, h, MARGIN))
    rng = np.random.default_rng(5)
    cbox = np.stack([[rng.normal() * 0.01, rng.normal() * 0.02,
                      0.034 + rng.uniform(-0.002, 0.015)]
                     for _ in range(12)])
    Rbox = np.stack([rot(rng.normal(size=3)) for _ in range(12)])
    # one sample point strictly inside the box: excluded on both sides
    cbox[11] = [0.0, 0.0, 0.001]
    ccyl = np.zeros((12, 3))
    axis = np.tile([1.0, 0.0, 0.0], (12, 1))
    mine = bc.box_cylinder(T(cbox), T(Rbox), half, T(ccyl), T(axis), r, h,
                           MARGIN)
    nonempty = 0
    for i in range(12):
        ref = jfn(*(jnp.asarray(x[i]) for x in (cbox, Rbox, ccyl, axis)))
        np.testing.assert_array_equal(mine.include[i], ref.include)
        np.testing.assert_allclose(mine.dist[i], ref.dist, rtol=0,
                                   atol=1e-12)
        inc = np.asarray(ref.include)
        np.testing.assert_allclose(mine.pos[i].numpy()[inc],
                                   np.asarray(ref.pos)[inc], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(mine.frame[i].numpy()[inc],
                                   np.asarray(ref.frame)[inc], rtol=0,
                                   atol=1e-12)
        nonempty += bool(inc.any())
    assert nonempty >= 4
    assert not mine.include[11, 0]


# ------------------------------------------------------------ states

def random_states14(seed, n):
    """The generator of tests/test_block_parity.py, stacked: robot touching
    the floor; block on the floor or in the air, every third one right at
    the robot. qpos (n,16), qvel (n,14), ctrl (n,2)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(n):
        qpos = np.zeros(16)
        qpos[:3] = [rng.normal() * 0.01, rng.normal() * 0.01,
                    -0.0205 + rng.uniform(-0.002, 0.004)]
        if trial % 2 == 0:
            qq = Rotation.from_euler("xyz", rng.normal(size=3) * 0.2) \
                .as_quat()
            q = np.array([qq[3], qq[0], qq[1], qq[2]])
        else:
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
        qpos[3:7] = q
        qpos[7:9] = rng.normal(size=2)
        near_robot = trial % 3 == 0
        qpos[9:11] = (qpos[:2] + rng.normal(size=2) * 0.05 if near_robot
                      else rng.normal(size=2) * 0.3)
        qpos[11] = (0.01 + rng.uniform(-0.005, 0.02) if trial % 2 == 0
                    else rng.uniform(0.05, 0.2))
        qb = rng.normal(size=4)
        qpos[12:16] = qb / np.linalg.norm(qb)
        qvel = rng.normal(size=14) * np.array(
            [.1, .1, .1, 1, 1, 1, 5, 5, 2, 2, 2, 3, 3, 3])
        out.append((qpos, qvel, rng.normal(size=2) * 10))
    return tuple(np.stack(x) for x in zip(*out))


def impact_states(B, seed=0):
    """A resting robot with the block a few mm from it, flying at it: at
    the chassis face (tumbling, so edges follow), at a wheel, along the
    floor. The impact falls inside the first control step."""
    rng = np.random.default_rng(seed)
    qpos = np.tile([0, 0, -0.0205, 1, 0, 0, 0, 0, 0, 0, 0.06, 0.15, 1, 0, 0,
                    0], (B, 1)).astype(np.float64)
    qpos[:, :2] += rng.normal(size=(B, 2)) * 0.01
    qpos[:, 9:11] += rng.normal(size=(B, 2)) * 0.01
    qb = rng.normal(size=(B, 4))
    qpos[:, 12:16] = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    qvel = np.zeros((B, 14))
    qvel[:, 8:11] = rng.normal(size=(B, 3)) * 0.5
    qvel[:, 9] -= 3.0
    if B > 2:
        qpos[2, 9:12] = [0.074, 0.062, 0.03]             # at the right wheel
    if B > 3:
        qpos[3, 9:12] = [0.0, 0.3, 0.001]                # sliding on the floor
        qvel[3, 8:11] = [0.0, -1.0, 0.0]
    ctrl = rng.normal(size=(B, 2)) * 5
    return qpos, qvel, ctrl


def jparams(fast):
    return jfast_solver(jbs.ENV03_PARAMS) if fast else jbs.ENV03_PARAMS


def tparams(fast):
    return fast_solver(bs.ENV03_PARAMS) if fast else bs.ENV03_PARAMS


def test_env03_params_are_a_value_copy():
    import dataclasses
    assert dataclasses.asdict(bs.ENV03_PARAMS) == {
        k: v for k, v in dataclasses.asdict(jbs.ENV03_PARAMS).items()}
    for name in ("BLOCK_FLOOR", "BLOCK_CHASSIS", "BLOCK_WHEEL"):
        assert dataclasses.asdict(getattr(bs, name)) == dataclasses.asdict(
            getattr(jbs, name))
    for name in ("BLOCK_MASS", "BLOCK_I", "BLOCK_HALF", "BLOCK_MARGIN",
                 "BLOCK_DOFS", "NV"):
        assert getattr(bs, name) == getattr(jbs, name)


# ------------------------------------------------------------ rows

def test_build_rows_sets_reproduces_build_rows():
    """build_rows_sets on the robot's 16 floor candidates (constant floor
    frame, one-body chains) gives the rows of `build_rows`: the frame
    products only add exact zeros."""
    qpos, qvel, _ = random_states14(7, 6)
    k = rc.fk(T(qpos[:, :9]))
    p = rc.ENV02_PARAMS
    ref = rw.build_rows(ct.robot_floor_contacts(k), k["cdof"], k["com"],
                        T(qvel[:, :8]), p)
    sets = bs.contact_sets(k, T(qpos[:, 9:12]), torch.eye(3, dtype=F64)
                           .expand(6, 3, 3), p)[:3]
    sets = [s._replace(sign=s.sign[:8]) for s in sets]
    mine = rw.build_rows_sets(sets, k["cdof"], k["com"].unsqueeze(1)
                              .expand(6, 8, 3), T(qvel[:, :8]))
    for a, b, name in zip(mine, ref, ref._fields):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-14, msg=name)
    assert mine.mask.sum() > 0


# ------------------------------------------------------------ substep

@functools.lru_cache(maxsize=None)
def _jax_substep14(fast):
    p = jparams(fast)

    def one(qpos, qvel, ws, ctrl):
        s = jbs.substep14(jbs.PhysState14(tuple(qpos), tuple(qvel),
                                          tuple(ws)), tuple(ctrl), p)
        return jnp.stack(s.qpos), jnp.stack(s.qvel), jnp.stack(s.warmstart)
    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_substep14_matches_jax(x64, fast):
    n = 18
    qpos, qvel, ctrl = random_states14(3, n)
    ws = np.random.default_rng(4).normal(size=(n, 14)) * 10
    ws[::2] = 0.0
    jq, jv, jw = _jax_substep14(fast)(qpos, qvel, ws, ctrl)
    seen = {}
    s = bs.control_step14(bs.PhysState14(T(qpos), T(qvel), T(ws)), T(ctrl),
                          tparams(fast), frame_skip=1, contact_counts=seen)
    np.testing.assert_allclose(s.qpos, jq, rtol=0, atol=1e-13)
    np.testing.assert_allclose(s.qvel, jv, rtol=0, atol=1e-12)
    scale = max(1.0, float(np.abs(jw).max()))
    np.testing.assert_allclose(s.warmstart / scale, np.asarray(jw) / scale,
                               rtol=0, atol=1e-12)
    # the states reach the block's contacts with the floor and the robot
    assert int(seen["block_floor"].sum()) >= 2
    assert int((seen["chassis_block_face"] | seen["chassis_block_edge"]
                | seen["wheel_block"]).sum()) >= 3


# ------------------------------------------------------------ control step

@functools.lru_cache(maxsize=None)
def _jax_control_step14(fast):
    p = jparams(fast)

    def one(qpos, qvel, ws, ctrl):
        s = jbs.control_step14(jbs.PhysState14(tuple(qpos), tuple(qvel),
                                               tuple(ws)), tuple(ctrl), p)
        return jnp.stack(s.qpos), jnp.stack(s.qvel), jnp.stack(s.warmstart)
    return jax.jit(jax.vmap(one))


def test_control_step14_plain_matches_jax_through_an_impact(x64):
    """The plain version of K2 over 250 substeps, fast grade, B = 4: the
    block hits the chassis (two envs), a wheel and the floor inside the
    step. 250 substeps of rounding through ~1e4 N/m-stiff contacts: qpos
    to 1e-11, qvel to 1e-9, the warm start to 1e-9 of its scale."""
    B = 4
    qpos, qvel, ctrl = impact_states(B)
    ws = np.zeros((B, 14))
    jq, jv, jw = _jax_control_step14(True)(qpos, qvel, ws, ctrl)
    seen = {}
    out = cuda_block.control_step14_plain(T(qpos), T(qvel), T(ws), T(ctrl),
                                          tparams(True), contact_counts=seen)
    assert cuda_block.KERNEL.launches == 0
    np.testing.assert_allclose(out[0], jq, rtol=0, atol=1e-11)
    np.testing.assert_allclose(out[1], jv, rtol=0, atol=1e-9)
    scale = max(1.0, float(np.abs(jw).max()))
    np.testing.assert_allclose(out[2] / scale, np.asarray(jw) / scale,
                               rtol=0, atol=1e-9)
    assert seen["chassis_block_face"][:2].all()
    assert seen["wheel_block"][2] and seen["block_floor"][3]
    # the impact really changed the block's flight
    assert (np.abs(np.asarray(jv)[:3, 8:11] - qvel[:3, 8:11]).max(1)
            > 0.5).all()
