"""Environment core: the RobotBaseEnv contract on batch-first tensors.

Counterpart of `balance_robot_tpu/envs/base.py`:

  * obs(6) = [pitch/0.25, fd-pitch_dot/1.0, vel_l/170*4, vel_r/170*4,
              (target_speed - wheel_speed)/170*4,
              (target_yaw - wheel_yaw)/45*3]
    where the finite-difference pitch_dot carries last_pitch/last_t across
    steps, and reset re-anchors it to the new episode's pitch at t = 0;
  * pitch = extrinsic-xyz euler x-angle of the chassis quaternion;
  * the base balance reward, including its as-built sign quirk
    `average_wheel_speed = (-vel_l + vel_r) / 2`.

Dtypes follow the JAX package field by field: `t` is an int32 control-step
count and time is float32 (`t * 5 ms`), so the fd pitch_dot divides by a
float32 dt; physics fields and rewards keep the working dtype.
"""

import math
from typing import NamedTuple

import torch

from ..physics.step import PhysState
from ..physics.slin import qmat, qmul

PITCH_MAX = 0.25
PITCH_DOT_MAX = 1.0
WHEEL_SPEED_MAX = 170.0
WHEEL_SPEED_DELTA_MAX = 4.0
YAW_MAX = 45.0
CONTROL_DT = 0.005
TERMINATE_PITCH = 50.0 * math.pi / 180.0


_CONSTANTS = {}


def device_constant(name, values, device, dtype):
    """`values` as a tensor on `device` in `dtype`, made once per (name,
    device, dtype) and kept. A step that built it anew would copy it from
    the host, and a blocking host-to-device copy makes the host wait until
    the card has run every launch queued before it."""
    key = (name, torch.device(device), dtype)
    if key not in _CONSTANTS:
        # a normal tensor even where the first caller is in inference mode
        with torch.inference_mode(False):
            _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTANTS[key]


class EnvState(NamedTuple):
    phys: PhysState
    t: torch.Tensor                   # (B,) int32 control steps this episode
    last_pitch: torch.Tensor          # (B,) fd-pitch_dot state
    last_t: torch.Tensor              # (B,) float32 time of the last obs
    has_last: torch.Tensor            # (B,) bool
    target_wheel_speed: torch.Tensor  # (B,)
    target_yaw: torch.Tensor          # (B,)
    aux: dict                         # env-specific (B,) slots


def tree_map(fn, *trees):
    """fn over the matching tensor leaves of (named) tuples and dicts, such
    as EnvStates."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        leaves = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*leaves) if hasattr(first, "_fields") \
            else tuple(leaves)
    return fn(*trees)


def time_of(state: EnvState):
    return state.t.to(torch.float32) * CONTROL_DT


# ------------------------------------------------------------ kinematics

def pitch_of(qpos):
    """Euler-x (extrinsic xyz) of the chassis quaternion, scipy-compatible,
    with the reference's qpos[3] == 0 -> 0 guard."""
    q = qpos[:, 3:7]
    n = q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30)
    w, x, y, z = (q / n).unbind(-1)
    pitch = torch.atan2(2 * (y * z + w * x), 1 - 2 * (x * x + y * y))
    return torch.where(qpos[:, 3] == 0.0, torch.zeros_like(pitch), pitch)


def yaw_of(qpos):
    """Euler-z (extrinsic xyz) of the chassis quaternion (reference
    get_yaw), with the same qpos[3] == 0 -> 0 guard."""
    q = qpos[:, 3:7]
    n = q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30)
    R = qmat(q / n)
    yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
    return torch.where(qpos[:, 3] == 0.0, torch.zeros_like(yaw), yaw)


def wheel_velocities(qvel):
    return qvel[:, 6], qvel[:, 7]


def wheel_yaw(qvel):
    vel_l, vel_r = wheel_velocities(qvel)
    return vel_l + vel_r


def wheel_speed(qvel):
    vel_l, vel_r = wheel_velocities(qvel)
    return (vel_l - vel_r) / 2.0


def yaw_dot(qvel):
    return qvel[:, 5]


# ------------------------------------------------------------ obs / reward

def fd_pitch_dot(state: EnvState, pitch):
    """Finite difference against the previous obs.

    Returns (pitch_dot, new last_pitch, new last_t, new has_last)."""
    t = time_of(state)
    dt = t - state.last_t
    ok = state.has_last & (dt > 0.0)
    pd = torch.where(ok, (pitch - state.last_pitch)
                     / torch.where(ok, dt, torch.ones_like(dt)),
                     torch.zeros_like(pitch))
    return pd, pitch, t, torch.ones_like(state.has_last)


def base_reward(state: EnvState, pitch):
    """RobotBaseEnv._get_reward with its as-built sign quirk."""
    qvel = state.phys.qvel
    vel_l, vel_r = wheel_velocities(qvel)
    average_wheel_speed = (-vel_l + vel_r) / 2.0
    dv = 0.0 - average_wheel_speed
    reward = 1.0 - 0.025 * (0.0 - yaw_dot(qvel)).abs()
    reward = reward - pitch.abs()
    return reward + pitch * dv * 0.5


# ------------------------------------------------------------ reset helpers

def scipy_euler_to_mj_quat_scrambled(x_rot, y_rot, z_rot):
    """The reference's reset quirk: scipy `from_euler('xyz').as_quat()`
    returns [x, y, z, w], which the reference writes raw into MuJoCo's
    [w, x, y, z] qpos slots. Returns that scrambled quaternion (B, 4),
    not renormalized or reordered."""
    def q_axis(half, axis):
        parts = [torch.cos(half)] + [torch.zeros_like(half)] * 3
        parts[1 + axis] = torch.sin(half)
        return torch.stack(parts, -1)

    q = qmul(q_axis(z_rot * 0.5, 2),
             qmul(q_axis(y_rot * 0.5, 1), q_axis(x_rot * 0.5, 0)))
    return torch.cat((q[:, 1:], q[:, :1]), -1)
