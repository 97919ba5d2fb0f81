"""Box-box and box-cylinder colliders of the Env03 block, batch-first.

Counterpart of `balance_robot_tpu/physics/box_collisions.py`, in array
form on `(B, ...)` tensors. This is the collider of the plain version of
kernel K2; the kernel's per-thread form is `csrc/box_collide.cuh`. Both
make the same discrete choices: the first index wins every tie (`max`,
`argmax` and the stable `argsort` all return the first of equal values).

Box-box: SAT over the 15 candidate axes, face axes preferred (an edge axis
must beat the best face separation by 5%), then

  * face case: the intersection polygon of the incident face with the
    reference face, as a fixed set of 24 candidates (4 incident-face
    corners inside the reference rectangle, 4 reference corners projected
    onto the incident face, 16 edge-pair intersections); the penetrating
    ones are kept, capped to the deepest 8;
  * edge-edge case: one closest-point contact.

Box-cylinder: 3 candidates (segment centre and both cap ends).

Contact frames follow MuJoCo's mju_makeFrame (helper = y axis when
|n_y| < 0.5, else z).
"""

import functools
from typing import NamedTuple

import torch

from .slin import vcross, mvmul


class PairContacts(NamedTuple):
    """Two-body contact candidates with per-contact frames."""
    pos: torch.Tensor       # (B, n, 3)
    dist: torch.Tensor      # (B, n)
    include: torch.Tensor   # (B, n) bool
    frame: torch.Tensor     # (B, n, 3, 3) rows (normal 1->2, t1, t2)


@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    def t(x, dt=dtype):
        return torch.tensor(x, dtype=dt, device=device)
    return dict(
        ey=t((0.0, 1.0, 0.0)), ez=t((0.0, 0.0, 1.0)),
        eye=torch.eye(3, dtype=dtype, device=device),
        perm1=t((1, 2, 0), torch.long), perm2=t((2, 0, 1), torch.long),
        t1i=t((1, 0, 0), torch.long), t2i=t((2, 2, 1), torch.long),
        rect2d=t(((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))),
        cyl_t=t((0.0, -1.0, 1.0)))


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return a.square().sum(-1).sqrt()


def _pick(x, idx):
    """x (B, n, ...) at per-env index idx (B,) -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def make_frames(n):
    """mju_makeFrame for normals (..., 3) -> frames (..., 3, 3)."""
    tb = _tables(n.dtype, n.device)
    use_y = n[..., 1:2].abs() < 0.5
    h = torch.where(use_y, tb["ey"], tb["ez"])
    t1 = h - n * _dot(n, h).unsqueeze(-1)
    t1 = t1 / _norm(t1).clamp_min(1e-15).unsqueeze(-1)
    return torch.stack((n, t1, vcross(n, t1)), -2)


def _cross2(x, y):
    return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]


def _manifold(cref, Aref, halfref, cinc, Ainc, halfinc, axis_idx, nsign, tb):
    """The 24 face candidates, computed in the reference box's frame.
    Aref / Ainc (B,3,3) rows = axes; axis_idx (B,) the reference face axis;
    nsign (B,). Returns world points (B,24,3), depths and validity."""
    dloc = mvmul(Aref, cinc - cref)                   # inc centre, ref frame
    Aloc = Aref @ Ainc.transpose(-1, -2)              # [i,j] = ref_i . inc_j
    e_ref = tb["eye"][axis_idx]                       # (B,3) one-hot
    nref = nsign.unsqueeze(-1) * e_ref
    dots = (nref.unsqueeze(-2) @ Aloc).squeeze(-2)    # per incident axis
    inc_j = dots.abs().argmax(-1)
    e_inc = tb["eye"][inc_j]
    sgn_inc = torch.where(_dot(dots, e_inc) >= 0, -1.0, 1.0)
    inc_axes = Aloc.transpose(-1, -2)                 # rows = inc axes
    ctr = dloc + sgn_inc.unsqueeze(-1) * (
        (e_inc * halfinc).unsqueeze(-2) @ inc_axes).squeeze(-2)
    # the incident face's tangent axes are the two other incident axes
    perm1, perm2 = tb["perm1"][inc_j], tb["perm2"][inc_j]
    u = _pick(inc_axes, perm1) * halfinc[perm1].unsqueeze(-1)
    v = _pick(inc_axes, perm2) * halfinc[perm2].unsqueeze(-1)
    quad = torch.stack((ctr + u + v, ctr - u + v, ctr - u - v, ctr + u - v),
                       1)                             # (B,4,3)
    t1i, t2i = tb["t1i"][axis_idx], tb["t2i"][axis_idx]
    e_t1, e_t2 = tb["eye"][t1i], tb["eye"][t2i]
    h_t1, h_t2, href = halfref[t1i], halfref[t2i], halfref[axis_idx]

    # 1: incident-face corners inside the reference rectangle
    q_t1 = _dot(quad, e_t1.unsqueeze(1))
    q_t2 = _dot(quad, e_t2.unsqueeze(1))
    ok_q = (q_t1.abs() <= h_t1.unsqueeze(-1)) \
        & (q_t2.abs() <= h_t2.unsqueeze(-1))
    # 2: reference corners projected along nref onto the incident plane
    rect2d = tb["rect2d"]
    rect = rect2d[:, 0:1] * (e_t1 * h_t1.unsqueeze(-1)).unsqueeze(1) \
        + rect2d[:, 1:2] * (e_t2 * h_t2.unsqueeze(-1)).unsqueeze(1)
    m = vcross(u, v)
    m = m / _norm(m).clamp_min(1e-15).unsqueeze(-1)
    denom = _dot(nref, m)
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    tproj = _dot(ctr.unsqueeze(1) - rect, m.unsqueeze(1)) \
        / denom.unsqueeze(-1)
    proj = rect + tproj.unsqueeze(-1) * nref.unsqueeze(1)
    relp = proj - ctr.unsqueeze(1)
    cu = _dot(relp, u.unsqueeze(1)) / _dot(u, u).clamp_min(1e-15) \
        .unsqueeze(-1)
    cv = _dot(relp, v.unsqueeze(1)) / _dot(v, v).clamp_min(1e-15) \
        .unsqueeze(-1)
    ok_r = (cu.abs() <= 1.0) & (cv.abs() <= 1.0)
    # 3: edge-pair intersections in the 2D tangent plane
    P2 = torch.stack((q_t1, q_t2), -1)                # (B,4,2)
    R2d = rect2d * torch.stack((h_t1, h_t2), -1).unsqueeze(1)
    a0, a1 = P2, P2.roll(-1, 1)
    b0, b1 = R2d, R2d.roll(-1, 1)
    r = (a1 - a0).unsqueeze(2)                        # (B,4,1,2)
    s = (b1 - b0).unsqueeze(1)                        # (B,1,4,2)
    qp = b0.unsqueeze(1) - a0.unsqueeze(2)            # (B,4,4,2)
    rxs = _cross2(r, s)
    rxs_s = torch.where(rxs.abs() < 1e-14, 1e-14, rxs)
    tt = _cross2(qp, s) / rxs_s
    uu = _cross2(qp, r) / rxs_s
    ok_e = (rxs.abs() > 1e-14) & (tt >= 0) & (tt <= 1) & (uu >= 0) & (uu <= 1)
    edge3 = quad.unsqueeze(2) + tt.unsqueeze(-1) \
        * (quad.roll(-1, 1) - quad).unsqueeze(2)      # (B,4,4,3)
    cands = torch.cat((quad, proj, edge3.flatten(1, 2)), 1)
    oks = torch.cat((ok_q, ok_r, ok_e.flatten(1, 2)), 1)
    depth = nsign.unsqueeze(-1) * _dot(cands, e_ref.unsqueeze(1)) \
        - href.unsqueeze(-1)
    world = cref.unsqueeze(1) + cands @ Aref
    return world, depth, oks


def box_box(c1, R1, half1, c2, R2, half2, margin):
    """Contacts of boxes 1 and 2: centres c (B,3), rotations R (B,3,3) with
    columns = axes, half-extents as 3-tuples. Returns PairContacts of 9
    candidates (8 face + 1 edge) with the normal from box 1 to box 2."""
    tb = _tables(c1.dtype, c1.device)
    half1 = torch.tensor(half1, dtype=c1.dtype, device=c1.device)
    half2 = torch.tensor(half2, dtype=c1.dtype, device=c1.device)
    A1 = R1.transpose(-1, -2)            # rows = box axes in world
    A2 = R2.transpose(-1, -2)
    C = A1 @ A2.transpose(-1, -2)        # C[i,j] = a1_i . a2_j
    d = c2 - c1
    dp = mvmul(A1, d)
    dq = mvmul(A2, d)
    absC = C.abs()
    sep_f1 = dp.abs() - half1 - mvmul(absC, half2)
    sep_f2 = dq.abs() - half2 - mvmul(absC.transpose(-1, -2), half1)
    # edge axes
    ax_e = vcross(A1.unsqueeze(2), A2.unsqueeze(1)).flatten(1, 2)   # (B,9,3)
    ln = _norm(ax_e)
    ok_e = ln > 1e-9
    axn = ax_e / ln.clamp_min(1e-9).unsqueeze(-1)
    s_e = _dot(axn, d.unsqueeze(1))
    axn = axn * torch.where(s_e >= 0, 1.0, -1.0).unsqueeze(-1)
    r1 = mvmul((axn @ R1).abs(), half1)
    r2 = mvmul((axn @ R2).abs(), half2)
    sep_e = torch.where(ok_e, s_e.abs() - r1 - r2, -torch.inf)

    seps = torch.cat((sep_f1, sep_f2, sep_e), -1)
    separated = seps.max(-1).values >= margin
    face_sep, face_idx = seps[:, :6].max(-1)
    edge_sep, edge_idx = seps[:, 6:].max(-1)
    # face axes preferred: an edge axis must beat the best face separation
    # by 5% of its magnitude; ties (flush aligned faces) go to the faces
    use_edge = edge_sep > face_sep + 0.05 * face_sep.abs() + 1e-14

    # ---- face manifold, both reference choices, selected per env
    fi1 = face_idx.clamp(0, 2)
    ns1 = torch.where(_pick(dp, fi1) >= 0, 1.0, -1.0)
    w1, d1, o1 = _manifold(c1, A1, half1, c2, A2, half2, fi1, ns1, tb)
    fi2 = (face_idx - 3).clamp(0, 2)
    ns2 = torch.where(_pick(dq, fi2) >= 0, -1.0, 1.0)
    w2, d2, o2 = _manifold(c2, A2, half2, c1, A1, half1, fi2, ns2, tb)
    ref1 = face_idx < 3
    pts = torch.where(ref1[:, None, None], w1, w2)
    deps = torch.where(ref1[:, None], d1, d2)
    oks = torch.where(ref1[:, None], o1, o2)
    nface = torch.where(ref1[:, None], ns1.unsqueeze(-1) * _pick(A1, fi1),
                        -ns2.unsqueeze(-1) * _pick(A2, fi2))

    ok_face = oks & (deps < margin) & ~(use_edge | separated).unsqueeze(-1)
    key = torch.where(ok_face, deps, torch.inf)
    order = key.argsort(dim=-1, stable=True)[:, :8]
    sel_d = deps.gather(1, order)
    sel_ok = ok_face.gather(1, order)
    sel_p = pts.gather(1, order.unsqueeze(-1).expand(-1, -1, 3))
    pos_face = sel_p - 0.5 * sel_d.unsqueeze(-1) * nface.unsqueeze(1)
    frames_face = make_frames(nface).unsqueeze(1).expand(-1, 8, -1, -1)

    # ---- edge-edge contact
    axe = _pick(axn, edge_idx)
    ei = torch.div(edge_idx, 3, rounding_mode="floor")
    ej = edge_idx % 3
    a1v, a2v = _pick(A1, ei), _pick(A2, ej)
    sgn1 = torch.where(mvmul(A1, axe) >= 0, 1.0, -1.0)
    p1e = c1 + (((1.0 - tb["eye"][ei]) * sgn1 * half1).unsqueeze(-2)
                @ A1).squeeze(-2)
    sgn2 = torch.where(mvmul(A2, axe) >= 0, -1.0, 1.0)
    p2e = c2 + (((1.0 - tb["eye"][ej]) * sgn2 * half2).unsqueeze(-2)
                @ A2).squeeze(-2)
    r12 = p2e - p1e
    a12 = _dot(a1v, a2v)
    den = 1 - a12 * a12
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    ra1, ra2 = _dot(r12, a1v), _dot(r12, a2v)
    tpar = (ra1 - a12 * ra2) / den
    upar = (a12 * ra1 - ra2) / den
    mid = 0.5 * ((p1e + tpar.unsqueeze(-1) * a1v)
                 + (p2e + upar.unsqueeze(-1) * a2v))
    e_inc = use_edge & (edge_sep < margin) & ~separated
    return PairContacts(
        pos=torch.cat((pos_face, mid.unsqueeze(1)), 1),
        dist=torch.cat((sel_d, edge_sep.unsqueeze(-1)), -1),
        include=torch.cat((sel_ok, e_inc.unsqueeze(-1)), -1),
        frame=torch.cat((frames_face, make_frames(axe).unsqueeze(1)), 1))


def box_cylinder(cbox, Rbox, half, ccyl, axis, r, h, margin):
    """Contacts of boxes (cbox (B,3), Rbox (B,3,3)) with cylinders (centre
    ccyl, unit axis, radius r, half-length h): 3 candidates (segment
    centre, both cap ends), the normal from the cylinder to the box."""
    tb = _tables(cbox.dtype, cbox.device)
    half = torch.tensor(half, dtype=cbox.dtype, device=cbox.device)
    pc = ccyl.unsqueeze(1) + tb["cyl_t"][:, None] * h * axis.unsqueeze(1)
    lp = (pc - cbox.unsqueeze(1)) @ Rbox                   # box frame
    delta = lp - torch.minimum(torch.maximum(lp, -half), half)
    dl = _norm(delta)
    outside = dl > 1e-12
    nloc = delta / dl.clamp_min(1e-12).unsqueeze(-1)
    n = -(nloc @ Rbox.transpose(-1, -2))                   # cylinder -> box
    ca = _dot(n, axis.unsqueeze(1))
    perp = (1.0 - ca * ca).clamp_min(0.0).sqrt()
    support = r * perp
    dist = torch.where(outside, dl - support, -support - dl)
    surf = pc + support.unsqueeze(-1) * n
    pos = surf - 0.5 * dist.unsqueeze(-1) * n
    # a sample point strictly inside the box has no defined normal
    # (delta = 0); its row would push along arbitrary tangents, so it is
    # left out. Reachable dynamics enter through the outside regime.
    return PairContacts(pos=pos, dist=dist,
                        include=(dist < margin) & outside,
                        frame=make_frames(n))
