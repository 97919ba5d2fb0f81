"""Full physics step for the robot-only scenes (Env01 / Env02 family and
the walled corridor of EnvMove05).

Counterpart of `balance_robot_tpu/physics/step.py`. One `substep` is
MuJoCo's `mj_step` at timestep 2e-5 with the implicitfast integrator; one
`control_step` is 250 substeps under constant ctrl, 5 ms of simulation. The
previous substep's qacc warm-starts the constraint solver, like MuJoCo's
qacc_warmstart.

A scene whose params list `walls` (static axis-aligned boxes) adds, per
wall, one chassis-wall box-box contact set and two wheel-wall box-cylinder
sets. The walls belong to the world, so their rows carry -J(robot) only.

This is the plain PyTorch version of kernel K1 (`cuda_step.py`,
`csrc/control_step.cu`) and, with walls, of kernel K3 (`cuda_move.py`,
`csrc/control_step_walls.cu`): the same arithmetic, one tensor op at a time.
"""

import functools
from dataclasses import replace
from typing import NamedTuple

import torch

from . import robot_core as rc
from . import contacts as ct
from . import rows as rw
from . import solver as sv
from .box_collisions import box_box, box_cylinder
from .slin import chol_factor, chol_solve, mvmul, quat_integrate

# body invweights of the chassis and of a wheel (compiled model constants):
# a wall contact uses `wall_contact` with the touching body's invweight
CH_INVW = 1.2709072512005732
W_INVW = 3.3757186541109845
_SIGN_CHASSIS_WALL = rw.chain_sign(rc.NV, (), rw.CHAINS[0])
_SIGN_WHEEL_WALL = {w: rw.chain_sign(rc.NV, (), rw.CHAINS[w]) for w in (1, 2)}
# what `control_step(..., contact_counts=)` reports for a wall scene
WALL_CONTACT_KINDS = ("chassis_wall_face", "chassis_wall_edge", "wheel_wall",
                      "chassis_wall_flush", "two_walls")


class PhysState(NamedTuple):
    qpos: torch.Tensor        # (B, 9)
    qvel: torch.Tensor        # (B, 8)
    warmstart: torch.Tensor   # (B, 8) previous qacc


@functools.lru_cache(maxsize=None)
def wall_contact_params(wall_contact):
    """(chassis-wall, wheel-wall) ContactParams from a scene's wall_contact."""
    return (replace(wall_contact, invweight=CH_INVW),
            replace(wall_contact, invweight=W_INVW))


def wall_sets(k, p):
    """The robot against the static wall boxes of `p.walls`: per wall, in
    turn, chassis box-box (9 candidates, normal chassis -> wall), then left
    and right wheel box-cylinder (3 candidates each, box = wall)."""
    R = k["R"]
    B = R.shape[0]
    axis = R[:, :, 0]
    off = torch.tensor(rc.CHASSIS_OFF, dtype=R.dtype, device=R.device)
    chassis_center = k["pos"] + mvmul(R, off)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(B, 3, 3)
    ch_prm, w_prm = wall_contact_params(p.wall_contact)
    sets = []
    for center, half in p.walls:
        cw = torch.tensor(center, dtype=R.dtype, device=R.device).expand(B, 3)
        bb = box_box(chassis_center, R, rc.CHASSIS_HALF, cw, eye, half, 0.0)
        sets.append(rw.ContactSet(*bb, sign=_SIGN_CHASSIS_WALL,
                                  params=ch_prm))
        for wheel, xw in ((1, k["xpos_l"]), (2, k["xpos_r"])):
            bc = box_cylinder(cw, eye, half, xw, axis, rc.WHEEL_R,
                              rc.WHEEL_H, 0.0)
            sets.append(rw.ContactSet(*bc, sign=_SIGN_WHEEL_WALL[wheel],
                                      params=w_prm))
    return sets


def _count_wall_contacts(sets, counts):
    """OR into `counts` which WALL_CONTACT_KINDS are included per env."""
    chassis = torch.stack([s.include for s in sets[0::3]], 1)   # (B,W,9)
    wheels = torch.stack([sets[i].include | sets[i + 1].include
                          for i in range(1, len(sets), 3)], 1)  # (B,W,3)
    face = chassis[..., :8]
    touched = chassis.any(-1) | wheels.any(-1)                  # (B,W)
    seen = {"chassis_wall_face": face.any(-1).any(-1),
            "chassis_wall_edge": chassis[..., 8].any(-1),
            "wheel_wall": wheels.any(-1).any(-1),
            # a whole face against the wall: 4 or more manifold points
            "chassis_wall_flush": (face.sum(-1) >= 4).any(-1),
            "two_walls": touched.sum(-1) >= 2}
    for name, hit in seen.items():
        counts[name] = counts.get(name, False) | hit


def forward(state: PhysState, ctrl, p: rc.RobotSceneParams, friction=None,
            contact_counts=None):
    """mj_forward equivalent: returns (qacc, qfrc_total, dfdv, M)."""
    qpos, qvel = state.qpos, state.qvel
    k = rc.fk(qpos)
    kv = rc.com_vel(k, qvel)
    M = rc.crb_mass_matrix(k)
    bias = rc.rne_bias(k, kv, qvel, p.gravity)
    qfrc_act, dfdv = rc.actuation(ctrl, qvel, p)
    passive = torch.cat((torch.zeros_like(qvel[:, :6]),
                         -p.joint_damping * qvel[:, 6:]), -1)
    qfrc_smooth = qfrc_act + passive - bias
    a_smooth = chol_solve(chol_factor(M), qfrc_smooth)

    fric = friction if p.dynamic_friction else None
    rows = rw.build_rows(ct.robot_floor_contacts(k), k["cdof"], k["com"],
                         qvel, p, friction=fric)
    if p.walls:
        # the floor rows keep the flat-floor order; the wall rows follow
        # (the order of the rows changes no sum beyond rounding)
        sets = wall_sets(k, p)
        com_dof = k["com"].unsqueeze(1).expand(-1, rc.NV, 3)
        wall_rows = rw.build_rows_sets(sets, k["cdof"], com_dof, qvel)
        rows = sv.EfcRows(*(torch.cat(pair, 1)
                            for pair in zip(rows, wall_rows)))
        if contact_counts is not None:
            _count_wall_contacts(sets, contact_counts)
    # warm start: the better of the previous qacc and qacc_smooth by cost
    cost_ws = sv.cost(state.warmstart, a_smooth, M, rows)
    cost_sm = sv.cost(a_smooth, a_smooth, M, rows)
    a0 = torch.where((cost_ws < cost_sm).unsqueeze(-1), state.warmstart,
                     a_smooth)
    qacc = sv.solve_newton(a0, a_smooth, M, rows, iters=p.newton_iters,
                           ls_iters=p.ls_iters)
    _, qfrc_con = sv.constraint_forces(qacc, rows)
    return qacc, qfrc_smooth + qfrc_con, dfdv, M


def substep(state: PhysState, ctrl, p: rc.RobotSceneParams, friction=None,
            contact_counts=None):
    """One mj_step: forward dynamics + implicitfast integration."""
    qacc, qfrc_total, dfdv, M = forward(state, ctrl, p, friction,
                                        contact_counts)
    h = p.timestep
    # implicitfast: qvel += h * (M - h*D)^-1 qfrc_total, with
    # D = d(qfrc_passive + actuator)/dqvel, diagonal on the wheel dofs
    dD = torch.cat((torch.zeros_like(qacc[:, :6]),
                    h * (-p.joint_damping + dfdv)), -1)
    dv = chol_solve(chol_factor(M - torch.diag_embed(dD)), qfrc_total)
    qvel = state.qvel + h * dv
    qpos = state.qpos
    new_qpos = torch.cat((qpos[:, 0:3] + h * qvel[:, 0:3],
                          quat_integrate(qpos[:, 3:7], qvel[:, 3:6], h),
                          qpos[:, 7:9] + h * qvel[:, 6:8]), -1)
    return PhysState(qpos=new_qpos, qvel=qvel, warmstart=qacc)


def control_step(state: PhysState, ctrl, p: rc.RobotSceneParams,
                 friction=None, frame_skip=250, contact_counts=None):
    """frame_skip substeps at constant ctrl (250 = one 200 Hz step).

    For a wall scene `contact_counts`, a dict, receives for each of
    WALL_CONTACT_KINDS a (B,) bool tensor: whether that kind of wall contact
    was included in any substep."""
    for _ in range(frame_skip):
        state = substep(state, ctrl, p, friction, contact_counts)
    return state
