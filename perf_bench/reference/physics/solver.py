"""MuJoCo-parity soft-constraint solver (primal Newton, pyramidal cone).

Counterpart of `balance_robot_tpu/physics/solver.py`:

    qacc = argmin_a  1/2 (a - a_smooth)' M (a - a_smooth)
                     + 1/2 sum_i D_i * min(J_i a - aref_i, 0)^2

solved by MuJoCo's Newton method in qacc space: exact nv x nv Hessian
Cholesky plus the exact line search on the piecewise-quadratic cost, from
a warm start, for fixed trip counts (no early exit).

Rows are an `EfcRows` of batch-first tensors: J (B, R, nv), aref/D/mask
(B, R). Every sum over rows covers all R rows, masked ones included.
"""

from typing import NamedTuple

import torch

from .slin import chol_factor, chol_solve

MJ_MINVAL = 1e-15
MJ_MINMU = 1e-5


class EfcRows(NamedTuple):
    J: torch.Tensor       # (B, R, nv)
    aref: torch.Tensor    # (B, R)
    D: torch.Tensor       # (B, R)
    mask: torch.Tensor    # (B, R) 0/1


def impedance(pos, solimp):
    """MuJoCo constraint impedance d(r), with the x**power form."""
    d0, d1, width, mid, power = solimp
    x = (pos.abs() / width).clamp(0.0, 1.0)
    a = 1.0 / (mid ** (power - 1.0))
    b = 1.0 / ((1.0 - mid) ** (power - 1.0))
    y = torch.where(x < mid, a * x ** power, 1.0 - b * (1.0 - x) ** power)
    return (d0 + y * (d1 - d0)).clamp(0.0001, 0.9999)


def _matvec(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _jar(a, rows):
    return _matvec(rows.J, a) - rows.aref


def _active(x, mask):
    """mask where x < 0, else 0."""
    return torch.where(x < 0, mask, 0.0)


def cost(a, a_smooth, M, rows):
    jar = _jar(a, rows)
    act = _active(jar, rows.mask)
    da = a - a_smooth
    c = (0.5 * da * _matvec(M, da)).sum(-1)
    return c + 0.5 * (rows.D * act * jar * jar).sum(-1)


def solve_newton(a_init, a_smooth, M, rows, iters=8, ls_iters=8):
    """Fixed-iteration primal Newton matching MuJoCo's Newton solver."""
    J, D, mask = rows.J, rows.D, rows.mask
    Jt = J.transpose(-1, -2)
    a = a_init
    for _ in range(iters):
        jar = _jar(a, rows)
        Jtw = Jt * (D * _active(jar, mask)).unsqueeze(-2)       # J' W
        da = a - a_smooth
        g = _matvec(M, da) + _matvec(Jtw, jar)
        step = chol_solve(chol_factor(M + Jtw @ J), -g)
        # exact line search on the piecewise-quadratic phi(t):
        #   phi'(t)  = dMda + t dMd + sum_act D Jd (jar + t Jd)
        #   phi''(t) = dMd + sum_act D Jd Jd
        # (dMda, dMd) is one product, and so are the two row sums
        Jd = _matvec(J, step)
        Md = _matvec(M, step)
        base = Md.unsqueeze(-2) @ torch.stack((da, step), -1)   # (B, 1, 2)
        mDJd = mask * D * Jd
        jar_Jd = torch.stack((jar, Jd), -1)                      # (B, R, 2)
        t = torch.ones_like(base[:, 0, :1])                      # (B, 1)
        for _ in range(ls_iters):
            jt = torch.addcmul(jar, t, Jd)
            phi = torch.baddbmm(base, torch.where(jt < 0, mDJd, 0.0)
                                .unsqueeze(-2), jar_Jd)[:, 0]
            phi2 = phi[:, 1:]
            t = t - torch.addcmul(phi[:, :1], t, phi2) \
                / phi2.clamp_min(MJ_MINVAL)
        a = a + t.clamp_min(0.0) * step
    return a


def constraint_forces(a, rows):
    """Per-row pyramid forces (B, R) and qfrc_constraint (B, nv)."""
    f = rows.mask * rows.D * (-_jar(a, rows)).clamp_min(0.0)
    return f, _matvec(rows.J.transpose(-1, -2), f)
