"""Physics step of the Env03 scenes: robot (8 dof) + projectile block (6 dof).

Counterpart of `balance_robot_tpu/physics/block_step.py`, batch-first. The
block is a free body in its own kinematic tree: the mass matrix is
block-diagonal (robot 8x8, m I3, I_block I3; the cube's inertia is
isotropic, so its rotation drops out) and only the contact rows, which
span all 14 dofs, couple the two trees. The robot half is `robot_core`;
the block half is free-body dynamics about its centre.

State layout: qpos (B, 16) = robot 9 + block (x, y, z, qw, qx, qy, qz);
qvel (B, 14) = robot 8 + block (v world, w body-local).

This is the plain PyTorch version of kernel K2 (`cuda_block.py`,
`csrc/control_step14.cu`): the same arithmetic, one tensor op at a time,
with the array-form colliders of `box_collisions.py`.

Block constants (compiled env03_v1.xml, inertiafromgeom): mass 0.064,
inertia 1.70667e-5 I3, half-extent 0.02, margin 0.002. Contact parameters:
solref (0.0125, 0.95) (the solmix average), default solimp, mu 1,
includemargin 0.002, invweight 15.625 plus the robot body's.
"""

from typing import NamedTuple

import torch

from . import robot_core as rc
from . import contacts as ct
from . import solver as sv
from . import rows as rw
from .box_collisions import box_box, box_cylinder
from .robot_core import ContactParams
from .slin import chol_factor, chol_solve, mvmul, qmat, qnormalize, \
    quat_integrate

NV = 14
BLOCK_MASS = 0.064
BLOCK_I = 1.7066666666666667e-05
BLOCK_HALF = (0.02, 0.02, 0.02)
BLOCK_MARGIN = 0.002
BLOCK_INVW = 15.625
BLOCK_DOFS = (8, 9, 10, 11, 12, 13)

BLOCK_FLOOR = ContactParams(
    solref=(0.0125, 0.95), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
    friction=(1.0, 1.0), margin=BLOCK_MARGIN, invweight=BLOCK_INVW)
BLOCK_CHASSIS = ContactParams(
    solref=(0.0125, 0.95), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
    friction=(1.0, 1.0), margin=BLOCK_MARGIN,
    invweight=1.2709072512005732 + BLOCK_INVW)
BLOCK_WHEEL = ContactParams(
    solref=(0.0125, 0.95), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
    friction=(1.0, 1.0), margin=BLOCK_MARGIN,
    invweight=3.3757186541109845 + BLOCK_INVW)

# env03_v1.xml has no <contact> block: the wheel and chassis floor contacts
# use the default geom-derived parameters, as env02 does
ENV03_PARAMS = rc.ENV02_PARAMS

_CHASSIS_DOFS = (0, 1, 2, 3, 4, 5)
_WHEEL_DOFS = {1: (0, 1, 2, 3, 4, 5, 6), 2: (0, 1, 2, 3, 4, 5, 7)}
_SIGN_WHEEL_FLOOR = {w: rw.chain_sign(NV, d) for w, d in _WHEEL_DOFS.items()}
_SIGN_CHASSIS_FLOOR = rw.chain_sign(NV, _CHASSIS_DOFS)
_SIGN_BLOCK_FLOOR = rw.chain_sign(NV, BLOCK_DOFS)
_SIGN_BLOCK_CHASSIS = rw.chain_sign(NV, BLOCK_DOFS, _CHASSIS_DOFS)
_SIGN_BLOCK_WHEEL = {w: rw.chain_sign(NV, BLOCK_DOFS, d)
                     for w, d in _WHEEL_DOFS.items()}

# the order of the contact sets in `contact_sets`' result
SET_NAMES = ("wheel_l_floor", "wheel_r_floor", "chassis_floor", "block_floor",
             "chassis_block", "wheel_l_block", "wheel_r_block")


class PhysState14(NamedTuple):
    qpos: torch.Tensor        # (B, 16)
    qvel: torch.Tensor        # (B, 14)
    warmstart: torch.Tensor   # (B, 14) previous qacc


def block_fk(qpos_b):
    """Block pose from its 7 qpos: (pos (B,3), quat (B,4), R (B,3,3))."""
    quat = qnormalize(qpos_b[:, 3:7])
    return qpos_b[:, 0:3], quat, qmat(quat)


def block_bias(qvel_b, gravity):
    """Free-body qfrc_bias (B, 6): gravity on the translations only. The
    gyroscopic term w x (I w) is zero for the isotropic cube inertia."""
    bias = [-BLOCK_MASS * g for g in gravity] + [0.0, 0.0, 0.0]
    return torch.tensor(bias, dtype=qvel_b.dtype,
                        device=qvel_b.device).expand(qvel_b.shape[0], 6)


def _floor_set(c, sign, params, includemargin=0.0):
    return rw.ContactSet(pos=c.pos, dist=c.dist - includemargin,
                         include=c.include, frame=rw.floor_frames(c.pos),
                         sign=sign, params=params)


def _pair_set(pc, sign, params):
    """Block-vs-robot-body candidates: efc pos = dist - includemargin."""
    return rw.ContactSet(pos=pc.pos, dist=pc.dist - BLOCK_MARGIN,
                         include=pc.include, frame=pc.frame, sign=sign,
                         params=params)


def contact_sets(k, pos_b, R_b, p):
    """The 7 ContactSets of the scene, in SET_NAMES order: 2 x 4 wheel-floor,
    8 chassis-floor, 8 block-floor, 9 chassis-block, 2 x 3 wheel-block."""
    R = k["R"]
    axis = R[:, :, 0]
    off = torch.tensor(rc.CHASSIS_OFF, dtype=R.dtype, device=R.device)
    chassis_center = k["pos"] + mvmul(R, off)
    sets = []
    for wheel, center in ((1, k["xpos_l"]), (2, k["xpos_r"])):
        sets.append(_floor_set(
            ct.plane_cylinder(center, axis, rc.WHEEL_R, rc.WHEEL_H, 0.0),
            _SIGN_WHEEL_FLOOR[wheel], p.wheel_contact))
    sets.append(_floor_set(
        ct.plane_box(chassis_center, R, rc.CHASSIS_HALF, 0.0),
        _SIGN_CHASSIS_FLOOR, p.chassis_contact))
    sets.append(_floor_set(
        ct.plane_box(pos_b, R_b, BLOCK_HALF, BLOCK_MARGIN),
        _SIGN_BLOCK_FLOOR, BLOCK_FLOOR, includemargin=BLOCK_MARGIN))
    sets.append(_pair_set(
        box_box(chassis_center, R, rc.CHASSIS_HALF, pos_b, R_b, BLOCK_HALF,
                BLOCK_MARGIN), _SIGN_BLOCK_CHASSIS, BLOCK_CHASSIS))
    for wheel, center in ((1, k["xpos_l"]), (2, k["xpos_r"])):
        sets.append(_pair_set(
            box_cylinder(pos_b, R_b, BLOCK_HALF, center, axis, rc.WHEEL_R,
                         rc.WHEEL_H, BLOCK_MARGIN),
            _SIGN_BLOCK_WHEEL[wheel], BLOCK_WHEEL))
    return sets


def forward14(state: PhysState14, ctrl, p: rc.RobotSceneParams):
    """mj_forward equivalent: (qacc, qfrc_total, dfdv, M, contact sets)."""
    qpos, qvel = state.qpos, state.qvel
    qpos_r, qvel_r, qvel_b = qpos[:, :9], qvel[:, :8], qvel[:, 8:]
    B = qpos.shape[0]

    k = rc.fk(qpos_r)
    kv = rc.com_vel(k, qvel_r)
    M_r = rc.crb_mass_matrix(k)
    bias_r = rc.rne_bias(k, kv, qvel_r, p.gravity)
    qfrc_act, dfdv = rc.actuation(ctrl, qvel_r, p)
    passive = torch.cat((torch.zeros_like(qvel_r[:, :6]),
                         -p.joint_damping * qvel_r[:, 6:]), -1)
    pos_b, _, R_b = block_fk(qpos[:, 9:])
    qfrc_smooth = torch.cat((qfrc_act + passive - bias_r,
                             -block_bias(qvel_b, p.gravity)), -1)

    M = qpos.new_zeros((B, NV, NV))
    M[:, :8, :8] = M_r
    M[:, 8:, 8:] = torch.diag(qpos.new_tensor([BLOCK_MASS] * 3
                                              + [BLOCK_I] * 3))
    a_smooth = chol_solve(chol_factor(M), qfrc_smooth)

    sets = contact_sets(k, pos_b, R_b, p)
    # block dofs: translations along world axes, rotations about the
    # block's own axes, both taken about the block's centre
    zeros = torch.zeros_like(R_b)
    cdof_b = torch.cat((
        torch.cat((zeros, torch.eye(3, dtype=qpos.dtype, device=qpos.device)
                   .expand(B, 3, 3)), -1),
        torch.cat((R_b.transpose(-1, -2), zeros), -1)), 1)       # (B,6,6)
    cdof = torch.cat((k["cdof"], cdof_b), 1)
    com_dof = torch.cat((k["com"].unsqueeze(1).expand(B, 8, 3),
                         pos_b.unsqueeze(1).expand(B, 6, 3)), 1)
    rows = rw.build_rows_sets(sets, cdof, com_dof, qvel)

    # warm start: the better of the previous qacc and qacc_smooth by cost
    cost_ws = sv.cost(state.warmstart, a_smooth, M, rows)
    cost_sm = sv.cost(a_smooth, a_smooth, M, rows)
    a0 = torch.where((cost_ws < cost_sm).unsqueeze(-1), state.warmstart,
                     a_smooth)
    qacc = sv.solve_newton(a0, a_smooth, M, rows, iters=p.newton_iters,
                           ls_iters=p.ls_iters)
    _, qfrc_con = sv.constraint_forces(qacc, rows)
    return qacc, qfrc_smooth + qfrc_con, dfdv, M, sets


def _integrate(state, qacc, qfrc_total, dfdv, M, p):
    h = p.timestep
    dD = torch.zeros_like(qacc)
    dD[:, 6:8] = h * (-p.joint_damping + dfdv)
    dv = chol_solve(chol_factor(M - torch.diag_embed(dD)), qfrc_total)
    qvel = state.qvel + h * dv
    qpos = state.qpos
    new_qpos = torch.cat((qpos[:, 0:3] + h * qvel[:, 0:3],
                          quat_integrate(qpos[:, 3:7], qvel[:, 3:6], h),
                          qpos[:, 7:9] + h * qvel[:, 6:8],
                          qpos[:, 9:12] + h * qvel[:, 8:11],
                          quat_integrate(qpos[:, 12:16], qvel[:, 11:14], h)),
                         -1)
    return PhysState14(qpos=new_qpos, qvel=qvel, warmstart=qacc)


def substep14(state: PhysState14, ctrl, p: rc.RobotSceneParams):
    """One mj_step of the 14-dof scene: forward dynamics + implicitfast."""
    qacc, qfrc_total, dfdv, M, _ = forward14(state, ctrl, p)
    return _integrate(state, qacc, qfrc_total, dfdv, M, p)


def control_step14(state: PhysState14, ctrl, p: rc.RobotSceneParams,
                   frame_skip=250, contact_counts=None):
    """frame_skip substeps at constant ctrl (250 = one 200 Hz step).

    `contact_counts`, a dict, receives for each of 'block_floor',
    'chassis_block_face', 'chassis_block_edge' and 'wheel_block' a (B,) bool
    tensor: whether that kind of contact was included in any substep."""
    for _ in range(frame_skip):
        qacc, qfrc_total, dfdv, M, sets = forward14(state, ctrl, p)
        if contact_counts is not None:
            inc = dict(zip(SET_NAMES, (s.include for s in sets)))
            seen = {
                "block_floor": inc["block_floor"].any(-1),
                "chassis_block_face": inc["chassis_block"][:, :8].any(-1),
                "chassis_block_edge": inc["chassis_block"][:, 8],
                "wheel_block": inc["wheel_l_block"].any(-1)
                | inc["wheel_r_block"].any(-1)}
            for name, hit in seen.items():
                contact_counts[name] = contact_counts.get(name, False) | hit
        state = _integrate(state, qacc, qfrc_total, dfdv, M, p)
    return state
