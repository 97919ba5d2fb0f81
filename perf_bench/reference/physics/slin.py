"""Small-dimension linear algebra on batch-first tensors.

Counterpart of `balance_robot_tpu/physics/slin.py`. There every per-env
quantity is a tuple of scalars that `vmap` turns into `(B,)` arrays; here
the batch leads every tensor and the small dimension trails it:

  * 3-vectors are `(..., 3)`, quaternions `(..., 4)` as (w, x, y, z);
  * 3x3 matrices are `(..., 3, 3)` with rows on the second-last axis;
  * spatial (6D) vectors are `(..., 6)` as (angular(3), linear(3)), MuJoCo
    c-frame; composite inertias are MuJoCo's 10-vector `(..., 10)`.

The dense SPD solves are batched Cholesky factorizations. The CUDA kernel
(`csrc/control_step.cu`) unrolls the same factorization per thread.
"""

import functools

import torch


# ---------------------------------------------------------------- vec3

def vcross(a, b):
    """a x b over the last axis of (..., 3) tensors (they broadcast)."""
    return torch.linalg.cross(a, b, dim=-1)


def mvmul(m, v):
    """m @ v for (..., 3, 3) m and (..., 3) v (v broadcasts)."""
    return (m * v.unsqueeze(-2)).sum(-1)


# ---------------------------------------------------------------- quat

# qmul(a, b) = Q(a) @ b with Q(a) built from a's components
_QMUL_IDX = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_QMUL_SIGN = ((1, -1, -1, -1), (1, 1, -1, 1), (1, 1, 1, -1), (1, -1, 1, 1))
# [v]x (cross-product matrix) of a 3-vector, from its components
_SKEW_IDX = ((0, 2, 1), (2, 0, 0), (1, 0, 0))
_SKEW_SIGN = ((0, -1, 1), (1, 0, -1), (-1, 1, 0))


@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    def t(x, dt=dtype):
        return torch.tensor(x, dtype=dt, device=device)
    return dict(qmul_idx=t(_QMUL_IDX, torch.long).flatten(),
                qmul_sign=t(_QMUL_SIGN), skew_idx=t(_SKEW_IDX,
                                                    torch.long).flatten(),
                skew_sign=t(_SKEW_SIGN), eye=torch.eye(3, dtype=dtype,
                                                       device=device))


def qmul(a, b):
    """Hamilton product of quaternions (..., 4), (w, x, y, z)."""
    tb = _tables(a.dtype, a.device)
    Q = a.index_select(-1, tb["qmul_idx"]).unflatten(-1, (4, 4)) \
        * tb["qmul_sign"]
    return (Q @ b.unsqueeze(-1)).squeeze(-1)


def qnormalize(q):
    return q * (1.0 / q.square().sum(-1, keepdim=True).sqrt())


def qmat(q):
    """Rotation matrix (..., 3, 3) of unit quaternions (..., 4):
    R = (1 - 2 v.v) I + 2 (v v^T + w [v]x)."""
    tb = _tables(q.dtype, q.device)
    w, v = q[..., :1], q[..., 1:]
    skew = v.index_select(-1, tb["skew_idx"]).unflatten(-1, (3, 3)) \
        * tb["skew_sign"]
    outer = v.unsqueeze(-1) * v.unsqueeze(-2)
    diag = (1 - 2 * v.square().sum(-1, keepdim=True)).unsqueeze(-1)
    return diag * tb["eye"] + 2 * (outer + w.unsqueeze(-1) * skew)


def quat_integrate(q, omega_local, h):
    """MuJoCo mj_integratePos for a free joint's quaternion:
    q <- normalize(q * exp(h * omega / 2)), omega body-local.

    A body at exact rest has norm 0: the axis is then divided by 1 (exact,
    since omega is 0) instead of a tiny epsilon that underflows in float32."""
    norm = omega_local.square().sum(-1).sqrt()
    angle = h * norm
    moving = norm > 0
    safe = torch.where(moving, norm, torch.ones_like(norm))
    axis = omega_local / safe.unsqueeze(-1)
    half = angle * 0.5
    s = torch.where(moving, torch.sin(half), torch.zeros_like(half))
    dq = torch.cat((torch.cos(half).unsqueeze(-1), axis * s.unsqueeze(-1)), -1)
    return qnormalize(qmul(q, dq))


# ------------------------------------------------------- spatial algebra

def motion_cross(v, s):
    """mju_crossMotion: v x s for spatial motion vectors (..., 6)."""
    va, vl = v[..., :3], v[..., 3:]
    sa, sl = s[..., :3], s[..., 3:]
    return torch.cat((vcross(va, sa), vcross(vl, sa) + vcross(va, sl)), -1)


def force_cross(v, f):
    """mju_crossForce: v x* f for a motion v and a force f (..., 6)."""
    va, vl = v[..., :3], v[..., 3:]
    fa, fl = f[..., :3], f[..., 3:]
    return torch.cat((vcross(va, fa) + vcross(vl, fl), vcross(va, fl)), -1)


# cinert components as a symmetric 3x3 inertia, row-major
_INERTIA_IDX = (0, 3, 4, 3, 1, 5, 4, 5, 2)


def inert_mul(ci, s):
    """mju_mulInertVec: cinert (..., 10) times motion vector (..., 6).

    cinert is (Ixx, Iyy, Izz, Ixy, Ixz, Iyz, hx, hy, hz, m), h = m * offset.
    """
    idx = torch.tensor(_INERTIA_IDX, device=ci.device)
    inertia = ci.index_select(-1, idx).unflatten(-1, (3, 3))
    h, m = ci[..., 6:9], ci[..., 9:10]
    sa, sl = s[..., :3], s[..., 3:]
    fa = mvmul(inertia, sa)
    return torch.cat((fa + vcross(h, sl), sl * m - vcross(h, sa)), -1)


# ---------------------------------------------------- dense SPD (batched)

def chol_factor(M):
    """Lower Cholesky factor of a batch of SPD matrices (B, n, n).

    The `_ex` form skips the error check, which would sync the host with
    the device on every call; the matrices here (mass matrix, Newton
    Hessian M + J'WJ) are positive definite by construction."""
    return torch.linalg.cholesky_ex(M)[0]


def chol_solve(L, b):
    """Solve (L L^T) x = b for a batch of factors (B, n, n) and b (B, n)."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
