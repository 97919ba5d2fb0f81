"""Full physics step for the robot-only scenes (Env01 / Env02 family).

Counterpart of the flat-floor path of `balance_robot_tpu/physics/step.py`.
One `substep` is MuJoCo's `mj_step` at timestep 2e-5 with the implicitfast
integrator; one `control_step` is 250 substeps under constant ctrl, 5 ms of
simulation. The previous substep's qacc warm-starts the constraint solver,
like MuJoCo's qacc_warmstart.

This is the plain PyTorch version of kernel K1 (`cuda_step.py`,
`csrc/control_step.cu`): the same arithmetic, one tensor op at a time.
"""

from typing import NamedTuple

import torch

from . import robot_core as rc
from . import contacts as ct
from . import solver as sv
from .rows import build_rows
from .slin import chol_factor, chol_solve, quat_integrate


class PhysState(NamedTuple):
    qpos: torch.Tensor        # (B, 9)
    qvel: torch.Tensor        # (B, 8)
    warmstart: torch.Tensor   # (B, 8) previous qacc


def forward(state: PhysState, ctrl, p: rc.RobotSceneParams, friction=None):
    """mj_forward equivalent: returns (qacc, qfrc_total, dfdv, M)."""
    if p.walls:
        raise NotImplementedError("wall scenes are not ported yet")
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
    rows = build_rows(ct.robot_floor_contacts(k), k["cdof"], k["com"], qvel,
                      p, friction=fric)
    # warm start: the better of the previous qacc and qacc_smooth by cost
    cost_ws = sv.cost(state.warmstart, a_smooth, M, rows)
    cost_sm = sv.cost(a_smooth, a_smooth, M, rows)
    a0 = torch.where((cost_ws < cost_sm).unsqueeze(-1), state.warmstart,
                     a_smooth)
    qacc = sv.solve_newton(a0, a_smooth, M, rows, iters=p.newton_iters,
                           ls_iters=p.ls_iters)
    _, qfrc_con = sv.constraint_forces(qacc, rows)
    return qacc, qfrc_smooth + qfrc_con, dfdv, M


def substep(state: PhysState, ctrl, p: rc.RobotSceneParams, friction=None):
    """One mj_step: forward dynamics + implicitfast integration."""
    qacc, qfrc_total, dfdv, M = forward(state, ctrl, p, friction)
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
                 friction=None, frame_skip=250):
    """frame_skip substeps at constant ctrl (250 = one 200 Hz step)."""
    for _ in range(frame_skip):
        state = substep(state, ctrl, p, friction)
    return state
