"""Constraint-row builder: pyramidal efc rows of the robot's floor contacts.

Counterpart of `balance_robot_tpu/physics/rows.py::build_rows` and of the
kernel-side `pallas_step.py::contact_rows_scalar`. Both JAX builders use
the same formulas and differ only in the order of the rows; this one
emits the order of the CUDA kernel (and of `contact_rows_scalar`): per
contact, the four rows (mu1, +), (mu1, -), (mu2, +), (mu2, -).

    Jpt[c, j]  = chain[c, j] * (cdof_lin[j] + cdof_ang[j] x (pos[c] - com))
    row        = n . Jpt  +-  mu * t_k . Jpt           (pyramidal cone)
    aref       = -b * (row . qvel) - k * imp * dist
    D          = 1 / max(MJ_MINVAL, (1 - imp) / imp * 2 mu^2 (1 + mu^2) invw)

with the floor frame (n, t1, t2) = ((0,0,1), (0,1,0), (-1,0,0)).

`build_rows` serves the robot-floor contacts of the 8-dof scenes. Its sibling
`build_rows_sets` takes `ContactSet`s with per-contact frames and signed
chains (J = J(body 2) - J(body 1) for a two-body contact), as the 14-dof
robot + block scene needs; it is the counterpart of the JAX package's
`rows.build_rows` over `ContactSet`s and of the kernel-side
`pallas_block.py::build_rows14_scalar`.
"""

import functools
from typing import NamedTuple

import torch

from . import solver as sv
from .contacts import CONTACT_BODY
from .slin import vcross

# dofs each body's Jacobian chain reaches: free joint 0-5, hinges 6 / 7
CHAINS = {0: (0, 1, 2, 3, 4, 5),
          1: (0, 1, 2, 3, 4, 5, 6),
          2: (0, 1, 2, 3, 4, 5, 7)}
# each contact's 4 rows: which friction direction, and the sign of mu
_ROW_DIR = (0, 0, 1, 1)
_ROW_SIGN = (1.0, -1.0, 1.0, -1.0)


@functools.lru_cache(maxsize=None)
def _tables(p, nv, dtype, device):
    """Per-contact constants (16 contacts in CONTACT_BODY order) of scene
    params `p`, evaluated in double as the JAX package does."""
    cols = {k: [] for k in ("chain", "d0", "d1", "width", "mid", "power",
                            "k", "b", "mu", "dA", "invw", "wheel")}
    for body in CONTACT_BODY:
        prm = p.wheel_contact if body else p.chassis_contact
        d0, d1, width, mid, power = prm.solimp
        tc, dr = prm.solref
        dmax = max(d0, d1)
        cols["chain"].append([1.0 if j in CHAINS[body] else 0.0
                              for j in range(nv)])
        for name, v in zip(("d0", "d1", "width", "mid", "power"),
                           prm.solimp):
            cols[name].append(v)
        cols["k"].append(1.0 / (dmax * dmax * tc * tc * dr * dr))
        cols["b"].append(2.0 / (dmax * tc))
        cols["mu"].append(prm.friction)
        cols["dA"].append([2.0 * m * m * (1.0 + m * m) * prm.invweight
                           for m in prm.friction])
        cols["invw"].append(prm.invweight)
        cols["wheel"].append(1.0 if body else 0.0)
    out = {k: torch.tensor(v, dtype=dtype, device=device)
           for k, v in cols.items()}
    out["wheel"] = out["wheel"].bool()
    out["row_dir"] = torch.tensor(_ROW_DIR, device=device)
    out["row_sign"] = torch.tensor(_ROW_SIGN, dtype=dtype, device=device)
    return out


def build_rows(contacts, cdof, com, qvel, p, friction=None):
    """EfcRows (B, 64, nv) of the 16 robot-floor candidates.

    contacts: robot_floor_contacts output; cdof (B, nv, 6); com (B, 3);
    qvel (B, nv); friction (B,) overrides the wheel pair's friction
    (clamped to MJ_MINMU) when given.
    """
    B, nv = cdof.shape[:2]
    tb = _tables(p, nv, cdof.dtype, cdof.device)
    rel = contacts.pos - com.unsqueeze(1)                       # (B,16,3)
    Jpt = (cdof[:, None, :, 3:] + vcross(cdof[:, None, :, :3],
                                         rel.unsqueeze(2))) \
        * tb["chain"].unsqueeze(-1)                             # (B,16,nv,3)
    Jn = Jpt[..., 2]
    Jt = torch.stack((Jpt[..., 1], -Jpt[..., 0]), 2)            # (B,16,2,nv)

    dist = contacts.dist
    imp = sv.impedance(dist, tuple(tb[k] for k in ("d0", "d1", "width",
                                                     "mid", "power")))

    mu, dA = tb["mu"], tb["dA"]                                 # (16,2)
    if friction is not None:
        m = friction.clamp_min(sv.MJ_MINMU)[:, None, None]      # (B,1,1)
        wheel = tb["wheel"][:, None]
        mu = torch.where(wheel, m, mu)
        dA = torch.where(wheel, 2.0 * m * m * (1.0 + m * m)
                         * tb["invw"][:, None], dA)
    D = 1.0 / (((1.0 - imp) / imp).unsqueeze(-1) * dA).clamp_min(
        sv.MJ_MINVAL)                                           # (B,16,2)

    rd = tb["row_dir"]
    smu = mu[..., rd] * tb["row_sign"]                          # (.,16,4)
    J = Jn.unsqueeze(2) + smu.unsqueeze(-1) * Jt[:, :, rd]      # (B,16,4,nv)
    vel = (J @ qvel[:, None, :, None]).squeeze(-1)
    aref = -tb["b"][:, None] * vel - (tb["k"] * imp * dist).unsqueeze(-1)
    mask = contacts.include.to(J.dtype).unsqueeze(-1).expand(B, -1, 4)
    return sv.EfcRows(J=J.flatten(1, 2), aref=aref.flatten(1),
                      D=D[..., rd].expand(B, -1, 4).flatten(1),
                      mask=mask.flatten(1))


# ------------------------------------------------- general frames, two bodies

FLOOR_FRAME = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))


class ContactSet(NamedTuple):
    """One homogeneous group of contact candidates (same params and chain)."""
    pos: torch.Tensor       # (B, n, 3) contact midpoints
    dist: torch.Tensor      # (B, n) efc pos (includemargin already subtracted)
    include: torch.Tensor   # (B, n) bool
    frame: torch.Tensor     # (B, n, 3, 3) rows = (normal, t1, t2)
    sign: tuple             # nv floats: +1 body-2 chain, -1 body-1 chain
    params: object          # ContactParams


def chain_sign(nv, body2_dofs, body1_dofs=()):
    """The static sign row of a contact between the chains of two bodies."""
    return tuple(1.0 if j in body2_dofs else -1.0 if j in body1_dofs else 0.0
                 for j in range(nv))


def floor_frames(pos):
    """The constant floor frame for contacts pos (B, n, 3): (B, n, 3, 3)."""
    f = torch.tensor(FLOOR_FRAME, dtype=pos.dtype, device=pos.device)
    return f.expand(pos.shape[0], pos.shape[1], 3, 3)


@functools.lru_cache(maxsize=None)
def _set_tables(spec, dtype, device):
    """Per-contact constants of the sets described by `spec`, a tuple of
    (n, sign, ContactParams), evaluated in double."""
    cols = {k: [] for k in ("sign", "d0", "d1", "width", "mid", "power",
                            "k", "b", "mu", "dA")}
    for n, sign, prm in spec:
        tc, dr = prm.solref
        dmax = max(prm.solimp[0], prm.solimp[1])
        for _ in range(n):
            cols["sign"].append(sign)
            for name, v in zip(("d0", "d1", "width", "mid", "power"),
                               prm.solimp):
                cols[name].append(v)
            cols["k"].append(1.0 / (dmax * dmax * tc * tc * dr * dr))
            cols["b"].append(2.0 / (dmax * tc))
            cols["mu"].append(prm.friction)
            cols["dA"].append([2.0 * m * m * (1.0 + m * m) * prm.invweight
                               for m in prm.friction])
    out = {k: torch.tensor(v, dtype=dtype, device=device)
           for k, v in cols.items()}
    out["row_dir"] = torch.tensor(_ROW_DIR, device=device)
    out["row_sign"] = torch.tensor(_ROW_SIGN, dtype=dtype, device=device)
    return out


def build_rows_sets(sets, cdof, com_dof, qvel):
    """EfcRows (B, 4 N, nv) of the N candidates of `sets` (ContactSets), 4
    rows per contact in the order (mu1,+), (mu1,-), (mu2,+), (mu2,-).

    cdof (B, nv, 6); com_dof (B, nv, 3), the point each dof's motion axis
    is taken about; qvel (B, nv).
    """
    spec = tuple((s.pos.shape[1], s.sign, s.params) for s in sets)
    tb = _set_tables(spec, cdof.dtype, cdof.device)
    pos, dist, include, frame = (torch.cat([s[i] for s in sets], 1)
                                 for i in range(4))
    B = pos.shape[0]
    rel = pos.unsqueeze(2) - com_dof.unsqueeze(1)               # (B,N,nv,3)
    Jpt = (cdof[:, None, :, 3:] + vcross(cdof[:, None, :, :3], rel)) \
        * tb["sign"].unsqueeze(-1)
    J3 = frame @ Jpt.transpose(-1, -2)                          # (B,N,3,nv)

    imp = sv.impedance(dist, tuple(tb[k] for k in ("d0", "d1", "width",
                                                     "mid", "power")))
    D = 1.0 / (((1.0 - imp) / imp).unsqueeze(-1) * tb["dA"]).clamp_min(
        sv.MJ_MINVAL)                                           # (B,N,2)
    rd = tb["row_dir"]
    smu = tb["mu"][:, rd] * tb["row_sign"]                      # (N,4)
    J = J3[:, :, 0:1] + smu.unsqueeze(-1) * J3[:, :, 1:][:, :, rd]
    vel = (J @ qvel[:, None, :, None]).squeeze(-1)              # (B,N,4)
    aref = -tb["b"][:, None] * vel - (tb["k"] * imp * dist).unsqueeze(-1)
    mask = include.to(J.dtype).unsqueeze(-1).expand(B, -1, 4)
    return sv.EfcRows(J=J.flatten(1, 2), aref=aref.flatten(1),
                      D=D[..., rd].flatten(1), mask=mask.flatten(1))
