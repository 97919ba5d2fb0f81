"""Rigid-body dynamics of the two-wheel balance robot on batch-first tensors.

Counterpart of `balance_robot_tpu/physics/robot_core.py` (MuJoCo's pipeline
for the robot-02 model: kinematics -> com-based inertias (cinert/cdof) ->
CRB mass matrix -> RNE bias -> velocity-servo actuation). State layout:

    qpos (B, 9) = (x, y, z, qw, qx, qy, qz, theta_l, theta_r)
    qvel (B, 8) = (vx, vy, vz [world], wx, wy, wz [body-local], dl, dr)

The scene parameters are a plain copy of the JAX package's dataclasses.
"""

import functools
from dataclasses import dataclass

import torch

from .slin import vcross, mvmul, qnormalize, qmat, motion_cross, \
    force_cross, inert_mul

NV = 8
FLOOR_Z = -0.02            # plane surface height (env01_v1.xml floor geom)
WHEEL_R = 0.034
WHEEL_H = 0.013            # half-length
CHASSIS_HALF = (0.05, 0.0185, 0.0855)
CHASSIS_OFF = (0.0, 0.0, 0.0995)   # chassis geom offset in body frame


@dataclass(frozen=True)
class ContactParams:
    """Per contact-type solver parameters (MuJoCo pair/geom-derived)."""
    solref: tuple          # (timeconst, dampratio)
    solimp: tuple          # (d0, d1, width, midpoint, power)
    friction: tuple        # (mu1, mu2)
    margin: float
    invweight: float       # sum of body_invweight0 translational


@dataclass(frozen=True)
class RobotSceneParams:
    """Static description of a robot-only scene."""
    timestep: float = 2e-5
    gravity: tuple = (0.0, 0.0, -9.81)
    # compiled masses / inertias (inertiafromgeom=true -> geom-derived)
    m_chassis: float = 0.6327
    m_wheel: float = 0.09442370879629483
    i_chassis: tuple = (0.0016139122500000002, 0.0020689817250000003,
                        0.0005994305250000002)
    i_wheel: tuple = (3.260765410432049e-05, 3.260765410432049e-05,
                      5.457690368425842e-05)
    chassis_ipos: tuple = (0.0, 0.0, 0.0995)
    wheel_pos_l: tuple = (-0.074, 0.0, 0.034)
    wheel_pos_r: tuple = (0.074, 0.0, 0.034)
    joint_damping: float = 0.01
    # actuator (velocity servo)
    act_gain: float = 4.0
    act_bias: float = -4.0
    ctrl_range: float = 78.54
    force_range: float = 0.65
    # contact params
    wheel_contact: ContactParams = ContactParams(
        solref=(0.02, 0.5), solimp=(0.5, 0.5, 0.002, 0.5, 2.0),
        friction=(0.9, 0.9), margin=0.0,
        invweight=3.3757186541109845)
    chassis_contact: ContactParams = ContactParams(
        solref=(0.02, 1.0), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
        friction=(1.0, 1.0), margin=0.0,
        invweight=1.2709072512005732)
    # env02: wheel friction taken from env state instead of the pair value
    dynamic_friction: bool = False
    # static wall boxes ((centre), (half-extents)) of the corridor scene
    walls: tuple = ()
    wall_contact: ContactParams = ContactParams(
        solref=(0.02, 1.0), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
        friction=(1.0, 1.0), margin=0.0,
        invweight=0.0)
    # solver iteration counts (fixed trip counts)
    newton_iters: int = 8
    ls_iters: int = 10


ENV01_PARAMS = RobotSceneParams()
# env02_v1.xml has no explicit <contact> pairs: wheels use default geom-derived
# params and the slide friction is randomized per episode
ENV02_PARAMS = RobotSceneParams(
    wheel_contact=ContactParams(
        solref=(0.02, 1.0), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
        friction=(1.0, 1.0), margin=0.0,
        invweight=3.3757186541109845),
    dynamic_friction=True,
)


# ===================================================================
# Smooth dynamics
# ===================================================================

@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    """Constant tensors of the robot model, per dtype and device."""
    p = ENV01_PARAMS

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)
    iw = (p.i_wheel[2], p.i_wheel[0], p.i_wheel[1])
    eye = torch.eye(3, dtype=dtype, device=device)
    # the two wheel subtrees are independent: M[6][7] = M[7][6] = 0
    wheel_pair = torch.ones(NV, NV, dtype=dtype, device=device)
    wheel_pair[6, 7] = wheel_pair[7, 6] = 0.0
    return dict(
        offsets=t((p.wheel_pos_l, p.wheel_pos_r, p.chassis_ipos)),
        # wheel inertia frame: the cylinder axis is body-x and the hinge
        # spins about it, so only the chassis orientation matters
        idiag=t((p.i_chassis, iw, iw)),
        mass=t((p.m_chassis, p.m_wheel, p.m_wheel)),
        eye=eye, trans=torch.cat((torch.zeros_like(eye), eye), -1),
        wheel_pair=wheel_pair)


def fk(qpos):
    """Forward kinematics + com quantities (mj_kinematics + mj_comPos).

    Returns a dict of batch-first tensors: pos (B,3), quat (B,4), R (B,3,3),
    xpos_l/xpos_r/xipos_ch (B,3), com (B,3), cinert (B,3,10) for
    (chassis, left wheel, right wheel), cdof (B,8,6).
    """
    tb = _tables(qpos.dtype, qpos.device)
    p = ENV01_PARAMS
    pos = qpos[:, 0:3]
    quat = qnormalize(qpos[:, 3:7])
    R = qmat(quat)
    body = pos.unsqueeze(1) + mvmul(R.unsqueeze(1), tb["offsets"])  # (B,3,3)
    xpos_l, xpos_r, xipos_ch = body.unbind(1)

    m_ch, m_w = p.m_chassis, p.m_wheel
    m_tot = m_ch + 2 * m_w
    com = (xipos_ch * m_ch + (xpos_l * m_w + xpos_r * m_w)) * (1.0 / m_tot)
    cinert = _cinert(R, tb["idiag"], tb["mass"],
                     body[:, (2, 0, 1)] - com.unsqueeze(1), tb["eye"])

    # cdof: free joint translations along world axes, rotations about the
    # body-local axes anchored at the body origin; hinges about -/+ body x
    axes = R.transpose(-1, -2)                         # rows = columns of R
    hinge = torch.stack((-axes[:, 0], axes[:, 0]), 1)
    ang = torch.cat((axes, hinge), 1)                               # (B,5,3)
    anchor = torch.stack((pos, pos, pos, xpos_l, xpos_r), 1)
    lin = vcross(ang, com.unsqueeze(1) - anchor)
    cdof = torch.cat((tb["trans"].expand(qpos.shape[0], 3, 6),
                      torch.cat((ang, lin), -1)), 1)
    return dict(pos=pos, quat=quat, R=R, xpos_l=xpos_l, xpos_r=xpos_r,
                xipos_ch=xipos_ch, com=com, cinert=cinert, cdof=cdof)


def _cinert(R, idiag, m, d, eye):
    """MuJoCo cinert 10-vectors (B, n, 10) of n bodies: world inertia
    R diag(idiag) R^T shifted by the parallel-axis term for offset d."""
    Rb = R.unsqueeze(1)                                        # (B,1,3,3)
    I = (Rb * idiag.unsqueeze(-2)) @ Rb.transpose(-1, -2)      # (B,n,3,3)
    dd = (d * d).sum(-1)                                       # (B,n)
    md = m.unsqueeze(-1) * d                                   # (B,n,3)
    I = I + (m * dd).unsqueeze(-1).unsqueeze(-1) * eye \
        - md.unsqueeze(-1) * d.unsqueeze(-2)
    flat = I.flatten(-2)[..., (0, 4, 8, 1, 2, 5)]
    return torch.cat((flat, md, m.expand_as(dd).unsqueeze(-1)), -1)


def com_vel(k, qvel):
    """mj_comVel: body spatial velocities cvel (B,3,6) and cdof_dot (B,8,6)."""
    cdof = k["cdof"]
    cvel_t = (cdof[:, 0:3] * qvel[:, 0:3, None]).sum(1)
    # free-joint rotation dofs: cdof_dot = (translation-only cvel) x cdof
    dot_rot = motion_cross(cvel_t.unsqueeze(1), cdof[:, 3:6])
    cvel_ch = cvel_t + (cdof[:, 3:6] * qvel[:, 3:6, None]).sum(1)
    dot_wheels = motion_cross(cvel_ch.unsqueeze(1), cdof[:, 6:8])
    cvel_w = cvel_ch.unsqueeze(1) + cdof[:, 6:8] * qvel[:, 6:8, None]
    cdof_dot = torch.cat((torch.zeros_like(cdof[:, 0:3]), dot_rot,
                          dot_wheels), 1)
    return dict(cvel=torch.cat((cvel_ch.unsqueeze(1), cvel_w), 1),
                cdof_dot=cdof_dot)


def crb_mass_matrix(k):
    """mj_crb: composite rigid body -> dense symmetric M (B, 8, 8).

    Column j is cdof' (I_j cdof_j), with I_j the composite inertia of the
    chassis subtree (all 3 bodies) for the free joint and the wheel's own
    for its hinge; the upper triangle is mirrored, and the two wheels, in
    different subtrees, do not couple."""
    cin, cdof = k["cinert"], k["cdof"]
    B = cdof.shape[0]
    inertia = torch.cat((cin.sum(1, keepdim=True).expand(B, 6, 10),
                         cin[:, 1:3]), 1)                       # (B,8,10)
    P = cdof @ inert_mul(inertia, cdof).transpose(-1, -2)
    upper = torch.triu(P) * _tables(P.dtype, P.device)["wheel_pair"]
    return upper + torch.triu(upper, 1).transpose(-1, -2)


def rne_bias(k, kv, qvel, gravity=(0.0, 0.0, -9.81)):
    """mj_rne(flg_acc=0): qfrc_bias (B, 8) = C(q,v)v + g."""
    cdof, cdof_dot = k["cdof"], kv["cdof_dot"]
    cvel, cin = kv["cvel"], k["cinert"]
    cacc0 = torch.tensor((0.0, 0.0, 0.0) + tuple(-g for g in gravity),
                         dtype=qvel.dtype, device=qvel.device)
    cacc_ch = cacc0 + (cdof_dot[:, :6] * qvel[:, :6, None]).sum(1)
    cacc_w = cacc_ch.unsqueeze(1) + cdof_dot[:, 6:8] * qvel[:, 6:8, None]
    cacc = torch.cat((cacc_ch.unsqueeze(1), cacc_w), 1)        # (B,3,6)
    frc = inert_mul(cin, cacc) + force_cross(cvel, inert_mul(cin, cvel))
    f_ch_tot = frc.sum(1)
    return torch.cat(((cdof[:, :6] * f_ch_tot.unsqueeze(1)).sum(-1),
                      (cdof[:, 6:8] * frc[:, 1:3]).sum(-1)), -1)


def actuation(ctrl, qvel, p: RobotSceneParams):
    """Velocity servo: force = clip(gain*clip(ctrl) + bias*qvel, +-forcerange).

    Returns (qfrc_actuator (B,8), dforce_dv (B,2)); dforce_dv is the
    velocity derivative used by implicitfast, zero where the force clamp is
    active.
    """
    c = ctrl.clamp(-p.ctrl_range, p.ctrl_range)
    raw = p.act_gain * c + p.act_bias * qvel[:, 6:8]
    frc = raw.clamp(-p.force_range, p.force_range)
    dfdv = torch.where(raw.abs() < p.force_range,
                       torch.full_like(raw, p.act_bias),
                       torch.zeros_like(raw))
    qfrc = torch.cat((torch.zeros_like(qvel[:, :6]), frc), -1)
    return qfrc, dfdv
