"""The step semantics of the envs, written out plainly: one file per env,
`<env id>.py` beside this one, each exporting its class as `ENV`; `load(env
id)` finds it by name, so a new env is a new file.

What one control step of an env does to its state, from the reference
project's env files (env01_v2.py, env03_v1.py, env03_v2.py and their base
class): reward from the pre-step state, 250 physics substeps at constant
ctrl, Env03's block events on the post-step state, termination at |pitch| >
50 deg, the observation from the post-step state, truncation at the
registered horizon. Randomness enters only through the uniforms `u` the
caller hands in (Env01-v2: 4 per env, the pitch noise of the reward, of the
termination and of the two obs reads; Env03-v2: 6 per env, a block launch's
direction, aim and orientation), so the step is a pure function.

A state is a dict of (B, ...) tensors: qpos, qvel, ws (the solver's warm
start), t (int control steps), last_pitch, last_t (float32 seconds),
has_last, target_wheel_speed, target_yaw, and Env03's delay_started,
delay_t0 (float32 seconds) and attack_front. Time is float32 (t x 5 ms), as
the reference's MuJoCo time read back as float32 is; everything else is
computed in the dtype of qpos.
"""

import math

import torch

import importlib.util
import sys
from pathlib import Path

from ..physics.slin import qmat, qmul

PITCH_MAX = 0.25
PITCH_DOT_MAX = 1.0
WHEEL_SPEED_MAX = 170.0
WHEEL_SPEED_DELTA_MAX = 4.0
YAW_MAX = 45.0
CONTROL_DT = 0.005
TERMINATE_PITCH = 50.0 * math.pi / 180.0
PARK_POS = (10.0, 10.0, 0.0)
SPAWN_RADIUS = 0.3
SPAWN_Z = float(torch.tensor(0.15, dtype=torch.float32))


def pitch_of(qpos):
    """Euler-x (extrinsic xyz) of the chassis quaternion, with the
    reference's qpos[3] == 0 -> 0 guard."""
    q = qpos[:, 3:7]
    n = q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30)
    w, x, y, z = (q / n).unbind(-1)
    pitch = torch.atan2(2 * (y * z + w * x), 1 - 2 * (x * x + y * y))
    return torch.where(qpos[:, 3] == 0.0, torch.zeros_like(pitch), pitch)


def yaw_of(qpos):
    q = qpos[:, 3:7]
    n = q.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-30)
    R = qmat(q / n)
    yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
    return torch.where(qpos[:, 3] == 0.0, torch.zeros_like(yaw), yaw)


def euler_quat_scrambled(x_rot, y_rot, z_rot):
    """scipy's from_euler('xyz').as_quat() ([x, y, z, w]) written raw into
    MuJoCo's [w, x, y, z] slots: the reference's reset quirk."""
    def q_axis(half, axis):
        parts = [torch.cos(half)] + [torch.zeros_like(half)] * 3
        parts[1 + axis] = torch.sin(half)
        return torch.stack(parts, -1)

    q = qmul(q_axis(z_rot * 0.5, 2),
             qmul(q_axis(y_rot * 0.5, 1), q_axis(x_rot * 0.5, 0)))
    return torch.cat((q[:, 1:], q[:, :1]), -1)


def bfloat16_state(physics, qpos, qvel, ws, ctrl, frame_skip=250):
    """The control's physics: the substeps in float32 (the plain physics
    has no bfloat16 solver), the state rounded to bfloat16 after each."""
    def rounded(x):
        return x.to(torch.bfloat16).to(torch.float32)

    state = [rounded(x) for x in (qpos, qvel, ws)]
    ctrl = rounded(ctrl)
    for _ in range(frame_skip):
        state = [rounded(x) for x in physics(*state, ctrl, frame_skip=1)]
    return tuple(x.to(torch.bfloat16) for x in state)


def time_of(t):
    return t.to(torch.float32) * CONTROL_DT


def base_reward(qvel, pitch):
    """RobotBaseEnv._get_reward, with its sign quirk
    average_wheel_speed = (-vel_l + vel_r) / 2."""
    vel_l, vel_r = qvel[:, 6], qvel[:, 7]
    dv = -(-vel_l + vel_r) / 2.0
    reward = 1.0 - 0.025 * qvel[:, 5].abs() - pitch.abs()
    return reward + pitch * dv * 0.5


def observe(state, pitch_obs, pitch_fd):
    """(obs (B, 6) in the state's dtype, fd-pitch slots of the next
    state)."""
    qvel = state["qvel"]
    t = time_of(state["t"])
    dt = t - state["last_t"]
    ok = state["has_last"] & (dt > 0.0)
    pd = torch.where(ok, (pitch_fd - state["last_pitch"])
                     / torch.where(ok, dt, torch.ones_like(dt)).to(
                         pitch_fd.dtype), torch.zeros_like(pitch_fd))
    vel_l, vel_r = qvel[:, 6], qvel[:, 7]
    wheel_speed = (vel_l - vel_r) / 2.0
    obs = torch.stack([
        pitch_obs / PITCH_MAX,
        pd / PITCH_DOT_MAX,
        vel_l / WHEEL_SPEED_MAX * 4.0,
        vel_r / WHEEL_SPEED_MAX * 4.0,
        (state["target_wheel_speed"] - wheel_speed) / WHEEL_SPEED_MAX * 4.0,
        (state["target_yaw"] - (vel_l + vel_r)) / YAW_MAX * 3.0], -1)
    slots = dict(last_pitch=pitch_fd, last_t=t,
                 has_last=torch.ones_like(state["has_last"]))
    return obs, slots




def load(env_id):
    """The reference class `ENV` of `<env_id>.py` in this folder; a class
    takes the solver's settings (`core.solver`) and steps a batch."""
    name = f"{__name__}.{env_id}"
    if name not in sys.modules:
        path = Path(__file__).with_name(f"{env_id}.py")
        if not path.exists():
            raise KeyError(f"no reference env {env_id!r} ({path.name})")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name].ENV
