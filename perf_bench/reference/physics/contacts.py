"""Floor contacts of the balance robot (MuJoCo-parity), batch-first.

Counterpart of `balance_robot_tpu/physics/contacts.py`:

  * plane-cylinder (wheels vs floor): 4 candidate support points -- the
    deepest rim point, the rim point at the opposite cap, and two lower-cap
    rim points at +-120 deg from the deepest direction; every candidate
    with dist < margin is a contact.
  * plane-box (chassis vs floor): of the 8 corners, the 4 deepest
    penetrating ones, ranked pairwise with the earlier corner winning ties.

The floor is the z = FLOOR_Z plane, so every contact frame is the constant
(n, t1, t2) = ((0,0,1), (0,1,0), (-1,0,0)). Candidates come in fixed-size
sets with an `include` mask, so no shape depends on the data.
"""

import functools
from typing import NamedTuple

import torch

from .robot_core import (FLOOR_Z, WHEEL_R, WHEEL_H, CHASSIS_HALF,
                         CHASSIS_OFF)
from .slin import vcross, mvmul

NORMAL = (0.0, 0.0, 1.0)

# body of each of the 16 robot-floor candidates, in the order
# robot_floor_contacts returns them: 0=chassis, 1=left wheel, 2=right wheel
CONTACT_BODY = (1,) * 4 + (2,) * 4 + (0,) * 8

_C120, _S120 = -0.5, 0.8660254037844386

# MuJoCo mjc_PlaneBox corner enumeration: corner i, component k is
# +half[k] if (i >> k) & 1 else -half[k]
_BOX_CORNERS = tuple(tuple((1.0 if (i >> k) & 1 else -1.0) for k in range(3))
                     for i in range(8))


class Contacts(NamedTuple):
    pos: torch.Tensor       # (B, n, 3) contact midpoints
    dist: torch.Tensor      # (B, n) signed distance
    include: torch.Tensor   # (B, n) bool


@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)
    idx = torch.arange(8, device=device)
    return dict(normal=t(NORMAL), ex=t((1.0, 0.0, 0.0)),
                corners=t(_BOX_CORNERS), chassis_off=t(CHASSIS_OFF),
                earlier=idx.unsqueeze(0) < idx.unsqueeze(1))      # j < i


def _floor_contacts(points, margin):
    dist = points[..., 2] - FLOOR_Z
    pos = torch.cat((points[..., :2],
                     (points[..., 2] - dist * 0.5).unsqueeze(-1)), -1)
    return pos, dist


def plane_cylinder(center, axis, r, h, margin):
    """Contacts of cylinders (center (..., 3), unit axis (..., 3), radius
    r, half-length h) with the floor: 4 candidates each, (..., 4, ...)."""
    tb = _tables(axis.dtype, axis.device)
    ca = axis[..., 2:3]
    w_raw = tb["normal"] - axis * ca
    wn = w_raw.square().sum(-1, keepdim=True).sqrt()
    # degenerate (axis vertical): fall back to the x direction
    w = torch.where(wn > 1e-10, w_raw / wn.clamp_min(1e-12), tb["ex"])
    a_s = torch.where(ca >= 0, axis, -axis)
    low_cap = center - a_s * h
    upp_cap = center + a_s * h
    rim = w * r
    v = vcross(a_s, w * -1.0)
    dir2 = (w * -1.0) * _C120 + v * _S120
    dir3 = (w * -1.0) * _C120 + v * (-_S120)
    points = torch.stack((low_cap - rim, upp_cap - rim,
                          low_cap + dir2 * r, low_cap + dir3 * r), -2)
    pos, dist = _floor_contacts(points, margin)
    return Contacts(pos, dist, dist < margin)


def plane_box(center, R, half, margin):
    """Contacts of oriented boxes (center (B,3), R (B,3,3), half-extents)
    with the floor: the 4 deepest penetrating corners of 8."""
    tb = _tables(R.dtype, R.device)
    local = tb["corners"] * torch.tensor(half, dtype=R.dtype, device=R.device)
    points = center.unsqueeze(1) + mvmul(R.unsqueeze(1), local)   # (B,8,3)
    pos, dist = _floor_contacts(points, margin)
    # rank by pairwise comparison, the earlier index winning ties: the
    # same rule as a stable argsort, written as elementwise ops as the
    # kernel computes it
    di, dj = dist.unsqueeze(-1), dist.unsqueeze(-2)                # i, j
    less = (dj < di) | ((dj == di) & tb["earlier"])
    rank = less.sum(-1)
    return Contacts(pos, dist, (dist < margin) & (rank < 4))


def robot_floor_contacts(k, wheel_margin=0.0, chassis_margin=0.0):
    """The 16 floor-contact candidates of the robot from fk output `k`:
    left wheel (4), right wheel (4), chassis (8), in CONTACT_BODY order.
    The wheel cylinder axis is the chassis-frame x axis."""
    R = k["R"]
    centers = torch.stack((k["xpos_l"], k["xpos_r"]), 1)          # (B,2,3)
    wheels = plane_cylinder(centers, R[:, None, :, 0], WHEEL_R, WHEEL_H,
                            wheel_margin)
    off = _tables(R.dtype, R.device)["chassis_off"]
    ch = plane_box(k["pos"] + mvmul(R, off), R, CHASSIS_HALF, chassis_margin)
    return Contacts(*(torch.cat((w.flatten(1, 2), c), 1)
                      for w, c in zip(wheels, ch)))
