"""The port's 8-dof physics against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through both packages: smooth dynamics,
contacts and constraint rows, one substep at both solver grades, a full
250-substep control step, and the plain version of kernel K1 against the
JAX Pallas kernel run in interpret mode. float64 unless stated: the two
sides run the same formulas in another operation order, so they agree to
rounding (~1e-13); the bounds below leave room for 250 substeps of it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from balance_robot_tpu.physics import contacts as jct
from balance_robot_tpu.physics import fast_solver as jfast_solver
from balance_robot_tpu.physics import pallas_step as jps
from balance_robot_tpu.physics import robot_core as jrc
from balance_robot_tpu.physics import solver as jsv
from balance_robot_tpu.physics import step as jst

from balance_robot_tpu_torch.physics import contacts as ct
from balance_robot_tpu_torch.physics import cuda_step
from balance_robot_tpu_torch.physics import fast_solver
from balance_robot_tpu_torch.physics import robot_core as rc
from balance_robot_tpu_torch.physics import rows as rw
from balance_robot_tpu_torch.physics import solver as sv
from balance_robot_tpu_torch.physics import step as st

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def random_states(seed, n):
    """Floor-contact states in every regime (tests/test_physics_parity.py's
    generator), stacked: qpos (n,9), qvel (n,8), ctrl (n,2), friction (n,)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(n):
        qpos = np.zeros(9)
        qpos[:3] = [rng.normal() * 0.01, rng.normal() * 0.01,
                    -0.0205 + rng.uniform(-0.002, 0.004)]
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if trial % 2 == 0:
            e = rng.normal(size=3) * 0.2
            qq = Rotation.from_euler("xyz", e).as_quat()
            q = np.array([qq[3], qq[0], qq[1], qq[2]])
        qpos[3:7] = q
        qpos[7:] = rng.normal(size=2)
        qvel = rng.normal(size=8) * np.array([.1, .1, .1, 1, 1, 1, 5, 5])
        ctrl = rng.normal(size=2) * 10
        out.append((qpos, qvel, ctrl, rng.uniform(0.5, 1.0)))
    return tuple(np.stack(x) for x in zip(*out))


def T(x, dtype=F64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def assert_close(actual, expected, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------ parameters

def test_params_are_a_value_copy_of_jax():
    for mine, ref in ((rc.ENV01_PARAMS, jrc.ENV01_PARAMS),
                      (rc.ENV02_PARAMS, jrc.ENV02_PARAMS),
                      (fast_solver(rc.ENV02_PARAMS),
                       jfast_solver(jrc.ENV02_PARAMS))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for name in ("NV", "FLOOR_Z", "WHEEL_R", "WHEEL_H", "CHASSIS_HALF",
                 "CHASSIS_OFF"):
        assert getattr(rc, name) == getattr(jrc, name), name
    assert (sv.MJ_MINMU, sv.MJ_MINVAL) == (jsv.MJ_MINMU, jsv.MJ_MINVAL)
    assert (fast_solver(rc.ENV01_PARAMS).newton_iters,
            fast_solver(rc.ENV01_PARAMS).ls_iters) == (4, 6)


# ------------------------------------------------------------ smooth fields

def test_smooth_fields(x64):
    qpos, qvel, ctrl, _ = random_states(0, 6)

    def jsmooth(qp, qv, c):
        k = jrc.fk(tuple(qp))
        kv = jrc.com_vel(k, tuple(qv))
        M = jrc.crb_mass_matrix(k)
        bias = jrc.rne_bias(k, kv, tuple(qv))
        act, dfdv = jrc.actuation(tuple(c), tuple(qv), jrc.ENV01_PARAMS)
        return (jnp.stack(k["com"]), jnp.asarray(k["cdof"]),
                jnp.asarray(k["cinert"]), jnp.asarray(kv["cdof_dot"]),
                jnp.asarray(M), jnp.stack(bias), jnp.stack(act),
                jnp.stack(dfdv))

    ref = jax.vmap(jsmooth)(qpos, qvel, ctrl)
    k = rc.fk(T(qpos))
    kv = rc.com_vel(k, T(qvel))
    act, dfdv = rc.actuation(T(ctrl), T(qvel), rc.ENV01_PARAMS)
    mine = (k["com"], k["cdof"], k["cinert"], kv["cdof_dot"],
            rc.crb_mass_matrix(k), rc.rne_bias(k, kv, T(qvel)), act, dfdv)
    for name, a, b in zip(("com", "cdof", "cinert", "cdof_dot", "M", "bias",
                           "act", "dfdv"), mine, ref):
        assert_close(a, b, atol=1e-12, rtol=1e-12, name=name)


@pytest.mark.parametrize("friction", [False, True])
def test_contacts_and_rows_match_kernel_order(x64, friction):
    """The port's row builder emits the rows of the Pallas kernel's
    contact_rows_scalar, in the same order."""
    qpos, qvel, _, fric = random_states(1, 6)
    params = rc.ENV02_PARAMS if friction else rc.ENV01_PARAMS
    jparams = jrc.ENV02_PARAMS if friction else jrc.ENV01_PARAMS

    def jrows(qp, qv, f):
        k = jrc.fk(tuple(qp))
        wheels, chassis = jct.robot_floor_contacts(k)
        cons = tuple(wheels) + tuple(chassis)
        rows = jps.contact_rows_scalar(cons, jparams, k["cdof"], k["com"],
                                       tuple(qv), 8,
                                       friction=f if friction else None)
        return (jnp.stack([jnp.stack(c.pos) for c in cons]),
                jnp.stack([c.dist for c in cons]),
                jnp.stack([c.include for c in cons]),
                jnp.stack(rows.Jc, -1), rows.aref, rows.D, rows.mask)

    ref = jax.vmap(jrows)(qpos, qvel, fric)
    k = rc.fk(T(qpos))
    cons = ct.robot_floor_contacts(k)
    rows = rw.build_rows(cons, k["cdof"], k["com"], T(qvel), params,
                         friction=T(fric) if friction else None)
    for name, a, b in zip(("pos", "dist", "include", "J", "aref", "D",
                           "mask"), tuple(cons) + tuple(rows), ref):
        assert_close(a, b, atol=1e-12, rtol=1e-12, name=name)
    assert np.asarray(ref[2]).any() and not np.asarray(ref[2]).all()


def test_plane_box_ties_go_to_the_earlier_corner(x64):
    """All 8 corners at one depth (a degenerate frame): the first 4 are the
    contacts, as the pairwise-rank rule of the JAX kernel picks them."""
    center = np.array([[0.0, 0.0, -0.03]])
    R = np.zeros((1, 3, 3))
    half = (0.05, 0.0185, 0.0855)
    cons = ct.plane_box(T(center), T(R), half, 0.0)
    ref = jct.plane_box(tuple(jnp.asarray(center[0])),
                        tuple(tuple(jnp.asarray(r)) for r in R[0]), half,
                        0.0, body=0)
    ref_inc = np.array([bool(c.include) for c in ref])
    assert ref_inc.tolist() == [True] * 4 + [False] * 4
    assert cons.include[0].tolist() == ref_inc.tolist()


# ------------------------------------------------------------ substeps

def _jax_state(qpos, qvel, ws):
    return jst.PhysState(tuple(qpos), tuple(qvel), tuple(ws))


@pytest.mark.parametrize("grade", ["exact", "fast"])
def test_substep(x64, grade):
    qpos, qvel, ctrl, _ = random_states(2, 8)
    p = rc.ENV01_PARAMS if grade == "exact" else fast_solver(rc.ENV01_PARAMS)
    jp = jrc.ENV01_PARAMS if grade == "exact" else jfast_solver(
        jrc.ENV01_PARAMS)
    ws = np.zeros((8, 8))

    def jsub(qp, qv, w, c):
        s = jst.substep(_jax_state(qp, qv, w), tuple(c), jp)
        return jnp.stack(s.qpos), jnp.stack(s.qvel), jnp.stack(s.warmstart)

    ref = jax.vmap(jsub)(qpos, qvel, ws, ctrl)
    mine = st.substep(st.PhysState(T(qpos), T(qvel), T(ws)), T(ctrl), p)
    assert_close(mine.qpos, ref[0], atol=1e-12)
    assert_close(mine.qvel, ref[1], atol=1e-10)
    # the warm start is qacc, up to ~1e4 in deep contact
    assert_close(mine.warmstart, ref[2], atol=1e-8, rtol=1e-10)


# ------------------------------------------------------------ control step

def test_control_step(x64):
    """250 substeps (fast grade, Env02's per-env friction) against JAX
    step.control_step in float64, and the port in float32 against the same
    float64 reference. The exact grade runs 10 control steps per env in
    tests/test_torch_envs.py."""
    qpos, qvel, ctrl, fr = random_states(3, 4)
    p, jp = fast_solver(rc.ENV02_PARAMS), jfast_solver(jrc.ENV02_PARAMS)
    ws = np.zeros((4, 8))

    def jctrl(qp, qv, w, c, f):
        s = jst.control_step(_jax_state(qp, qv, w), tuple(c), jp, friction=f)
        return jnp.stack(s.qpos), jnp.stack(s.qvel), jnp.stack(s.warmstart)

    ref = jax.jit(jax.vmap(jctrl))(qpos, qvel, ws, ctrl, fr)
    mine = cuda_step.control_step(T(qpos), T(qvel), T(ws), T(ctrl), T(fr), p)
    assert_close(mine[0], ref[0], atol=1e-10)
    assert_close(mine[1], ref[1], atol=1e-8)
    assert_close(mine[2], ref[2], atol=1e-6, rtol=1e-8)
    # float32: one control step of float32 rounding against float64
    f32 = torch.float32
    mine32 = cuda_step.control_step(
        T(qpos, f32), T(qvel, f32), T(ws, f32), T(ctrl, f32), T(fr, f32), p)
    assert mine32[0].dtype == f32
    assert_close(mine32[0], ref[0], atol=1e-5)


@pytest.mark.parametrize("friction", [False, True])
def test_plain_k1_matches_pallas_interpret(x64, friction):
    """K1's plain version against the Pallas kernel in interpret mode, on a
    ragged batch of 5 (as tests/test_pallas_step.py runs the kernel)."""
    qpos, qvel, ctrl, fric = random_states(4, 5)
    ws = np.zeros((5, 8))
    p = fast_solver(rc.ENV02_PARAMS if friction else rc.ENV01_PARAMS)
    jp = jfast_solver(jrc.ENV02_PARAMS if friction else jrc.ENV01_PARAMS)
    ref = jps.control_step_pallas(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ws),
        jnp.asarray(ctrl), jnp.asarray(fric) if friction else None, jp,
        frame_skip=3, interpret=True)
    mine = cuda_step.control_step_plain(
        T(qpos), T(qvel), T(ws), T(ctrl), T(fric) if friction else None, p,
        frame_skip=3)
    assert_close(mine[0], ref[0], atol=1e-12)
    assert_close(mine[1], ref[1], atol=1e-10)
    assert_close(mine[2], ref[2], atol=1e-8, rtol=1e-10)
