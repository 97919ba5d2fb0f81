"""Env03 family: balance while a 4 cm block is fired at the robot.

Counterpart of `balance_robot_tpu/envs/env03.py` (reference env03_v1.py /
env03_v2.py / env03_v1_fail.py), batch-first. When the block slows below
0.1 m/s it is parked at (10, 10, 0) and fired again after `block_delay`
seconds, from 0.3 m away at z = 0.15, aimed at the robot (v1: from a random
direction at 5 m/s; v2: always at the front or always at the back face,
chosen once per env instance, at 7.5 m/s every 0.5 s). Env03-v1-fail also
cuts the motors once the robot has fallen.

The block's physics is the 14-dof coupled control step
(`physics/cuda_block.py`: kernel K2 for CUDA tensors, its plain version
for CPU tensors); the events act between control steps, on the post-step
state with the post-step time.

Randomness: these envs are not noisy, so a step's only draws are the 6
uniforms per env of a block launch (direction, 2 of aim, 3 of
orientation), drawn every step and used where a block fires.
`step(..., uniforms=...)` takes them explicitly (B, 6) instead, so a caller
can replay another stream.

Tracing (`utils/profiling`, only while a `torch.profiler` session
records): `step` lies in the span `env03.step`, the park and fire events
in `env03.events` inside it, and a tally on the envs' device adds each
step's block launches and env-steps, folded into `profiling.counters()`
as `env03.block_launches` and `env03.env_steps`. Without a profiler
nothing is recorded and nothing waits for the device.
"""

import torch

from ..physics import block_step as bs
from ..physics.block_step import PhysState14
from ..physics.cuda_block import control_step14
from ..utils import profiling
from ..utils.profiling import span
from . import base
from .base import (EnvState, WHEEL_SPEED_DELTA_MAX, TERMINATE_PITCH,
                   pitch_of, yaw_of, scipy_euler_to_mj_quat_scrambled)
from .env01 import Env01V1

PARK_POS = (10.0, 10.0, 0.0)
SPAWN_RADIUS = 0.3
# the reference writes the spawn height as a float32 constant, so in
# float64 it is float32(0.15), not 0.15
SPAWN_Z = torch.tensor(0.15, dtype=torch.float32).item()

# per device: int64 (block launches, env-steps) of the steps traced since
# the store was last cleared
_tally = {}


def _count_launches(fire):
    """Add a step's launches and env-steps to the tally of its device."""
    t = _tally.get(fire.device)
    if t is None:
        # a normal tensor even under inference mode, so that clear may
        # zero it outside
        with torch.inference_mode(False):
            t = _tally[fire.device] = torch.zeros(2, dtype=torch.int64,
                                                  device=fire.device)
    t[0] += fire.sum()
    t[1] += fire.numel()


def _tally_read():
    if not _tally:
        return {}
    launches, steps = (int(x) for x in sum(
        t.cpu() for t in _tally.values()))
    return {"env03.block_launches": launches, "env03.env_steps": steps}


def _tally_clear():
    for t in _tally.values():
        t.zero_()


profiling.fold(_tally_read, _tally_clear)


class Env03V1(Env01V1):
    id = "Env03-v1"
    max_episode_steps = 6000
    params = bs.ENV03_PARAMS
    block_delay = 0.0
    block_speed = 5.0
    # reset euler ranges: x +-pi, y/z +-0.2 (env03_v1.py:67-70)
    reset_y_range = 0.2
    reset_z_range = 0.2
    # privileged critic features: the training-only value net (and the
    # teacher of PrivilegedObsEnv) may see the block; the actor keeps the
    # 6-obs interface of the real robot, which has no block sensor
    priv_dim = 8

    def _init_aux(self, n):
        return {"delay_started": self._zeros(n, torch.bool),
                "delay_t0": self._zeros(n, torch.float32)}

    def _attack_hint(self, state):
        """The side of the next launch where it belongs to the env instance
        (v2): +1 front / -1 back; 0 where each launch draws it (v1)."""
        return self._zeros(state.t.shape[0], torch.float32)

    def privileged(self, state):
        """(B, 8) float32 block features in the robot's heading frame:
        relative position / 0.3 (the spawn radius), velocity / block_speed,
        the parked flag and the attack-side hint. Position and velocity
        are zeroed while the block is parked (`delay_started`, the event
        machinery's own flag)."""
        qpos, qvel = state.phys.qpos, state.phys.qvel
        rel = qpos[:, 9:12] - qpos[:, 0:3]
        vel = qvel[:, 8:11]
        yaw = yaw_of(qpos)
        c, s = torch.cos(yaw), torch.sin(yaw)

        def heading(v):
            return torch.stack((c * v[:, 0] + s * v[:, 1],
                                -s * v[:, 0] + c * v[:, 1], v[:, 2]), -1)

        parked = state.aux["delay_started"]
        live = torch.where(parked, 0.0, 1.0).to(qpos.dtype).unsqueeze(-1)
        feats = torch.cat((
            heading(rel) * live / SPAWN_RADIUS,
            heading(vel) * live / self.block_speed,
            torch.stack((parked.to(qpos.dtype),
                         self._attack_hint(state).to(qpos.dtype)), -1)), -1)
        return feats.to(torch.float32)

    def reset(self, n):
        """n fresh episodes with the first block fired at once
        (env03_v1.py:80): (EnvState, obs (n, 6) float32)."""
        u = self._uniform(n, 19)
        qpos = self._zeros((n, 16))
        qpos[:, 3] = 1.0
        qpos[:, 12] = 1.0
        qpos = qpos + (u[:, :16] * 0.02 - 0.01)
        qpos[:, 2] = 0.0
        x_rot = (u[:, 16] - 0.5) * 2 * torch.pi
        y_rot = (u[:, 17] - 0.5) * 2 * self.reset_y_range
        z_rot = (u[:, 18] - 0.5) * 2 * self.reset_z_range
        qpos[:, 3:7] = scipy_euler_to_mj_quat_scrambled(x_rot, y_rot, z_rot)
        zeros = self._zeros((n, 14))
        state = EnvState(
            phys=PhysState14(qpos=qpos, qvel=zeros, warmstart=zeros.clone()),
            t=self._zeros(n, torch.int32),
            last_pitch=self._zeros(n), last_t=self._zeros(n, torch.float32),
            has_last=self._zeros(n, torch.bool),
            target_wheel_speed=self._zeros(n), target_yaw=self._zeros(n),
            aux=self._init_aux(n))
        qpos, qvel = self._spawn_block(state, self._uniform(n, 6))
        state = state._replace(phys=state.phys._replace(qpos=qpos, qvel=qvel))
        return self._obs(state, self._noise(n, 2))

    def state_from_qpos(self, qpos, qvel=None, aux=None):
        """EnvState from explicit (qpos (B, 16), qvel (B, 14)) and optionally
        the aux slots; the fd-pitch_dot state is seeded with (pitch0, 0)."""
        qpos = qpos.to(self.device, self.dtype)
        n = qpos.shape[0]
        qvel = (self._zeros((n, 14)) if qvel is None
                else qvel.to(self.device, self.dtype))
        return self.state_from_arrays(
            qpos, qvel, self._zeros((n, 14)), self._zeros(n, torch.int32),
            pitch_of(qpos), self._zeros(n, torch.float32),
            torch.ones(n, dtype=torch.bool), **(aux or {}))

    def state_from_arrays(self, qpos, qvel, warmstart, t, last_pitch, last_t,
                          has_last, target_wheel_speed=None, target_yaw=None,
                          **aux):
        """The batched EnvState for Env03 state arrays (numpy or tensors)
        with a leading batch axis: qpos (B,16), qvel (B,14), warmstart
        (B,14), t, the fd-pitch slots, and the aux slots of this env by name
        (`delay_started`, `delay_t0`, v2's `attack_front`, v1-fail's
        `fallen`). Slots not given keep their reset value."""
        def to(x, dtype):
            x = x if torch.is_tensor(x) else torch.tensor(x)
            return x.to(self.device, dtype)

        n = len(qpos)
        slots = self._init_aux(n)
        for name, value in aux.items():
            if name not in slots:
                raise KeyError(f"{self.id} has no aux slot {name!r}")
            slots[name] = to(value, slots[name].dtype)
        return EnvState(
            phys=PhysState14(qpos=to(qpos, self.dtype),
                             qvel=to(qvel, self.dtype),
                             warmstart=to(warmstart, self.dtype)),
            t=to(t, torch.int32), last_pitch=to(last_pitch, self.dtype),
            last_t=to(last_t, torch.float32), has_last=to(has_last,
                                                          torch.bool),
            target_wheel_speed=self._zeros(n) if target_wheel_speed is None
            else to(target_wheel_speed, self.dtype),
            target_yaw=self._zeros(n) if target_yaw is None
            else to(target_yaw, self.dtype),
            aux=slots)

    # ------------------------------------------------ block event machinery
    def _attack_angle(self, state, u):
        return u * 2 * torch.pi

    def _target_jitter(self):
        # (x jitter half-range, z low, z range), env03_v1.py:96-100
        return 0.03, 0.1, 0.075

    def _spawn_block(self, state, u):
        """set_block_pos_vel (env03_v1.py:88-114) for every env: the (qpos,
        qvel) with the block on the 0.3 m circle around the robot, flying
        at the aim point. u (B, 6): direction, 2 of aim, 3 of orientation."""
        qpos, qvel = state.phys.qpos, state.phys.qvel
        robot = qpos[:, 0:3]
        angle = self._attack_angle(state, u[:, 0])
        block_pos = torch.stack((
            SPAWN_RADIUS * torch.sin(angle) + robot[:, 0],
            SPAWN_RADIUS * torch.cos(angle) + robot[:, 1],
            torch.full_like(angle, SPAWN_Z)), -1)
        jx, zlo, zrange = self._target_jitter()
        target = torch.stack(((u[:, 1] - 0.5) * 2 * jx + robot[:, 0],
                              robot[:, 1], u[:, 2] * zrange + zlo), -1)
        v = target - block_pos
        v = self.block_speed * v / v.square().sum(-1, keepdim=True).sqrt()
        rot = u[:, 3:6] * 2 * torch.pi
        quat = scipy_euler_to_mj_quat_scrambled(rot[:, 0], rot[:, 1],
                                                rot[:, 2])
        return (torch.cat((qpos[:, :9], block_pos, quat), -1),
                torch.cat((qvel[:, :8], v, qvel[:, 11:]), -1))

    def _events(self, state, u):
        """Block slow -> park -> delayed respawn (env03_v1.py:39-49)."""
        qpos, qvel = state.phys.qpos, state.phys.qvel
        t = base.time_of(state)
        speed = qvel[:, 8:11].square().sum(-1).sqrt()
        started = state.aux["delay_started"]
        # 1) park the block when it is slow and no respawn is pending
        park = (speed < 0.1) & ~started
        park_pos = base.device_constant("PARK_POS", PARK_POS, qpos.device,
                                        qpos.dtype)
        qpos = torch.cat((qpos[:, :9],
                          torch.where(park.unsqueeze(-1), park_pos,
                                      qpos[:, 9:12]), qpos[:, 12:]), -1)
        t0 = torch.where(park, t, state.aux["delay_t0"])
        started = started | park
        state = state._replace(phys=state.phys._replace(qpos=qpos))
        # 2) respawn after the delay; a launch changes the block's pose and
        # linear velocity and nothing else
        fire = started & ((t - t0) > self.block_delay)
        if profiling.recording():
            _count_launches(fire)
        sq, sv = self._spawn_block(state, u)
        f = fire.unsqueeze(-1)
        return state._replace(
            phys=state.phys._replace(qpos=torch.where(f, sq, qpos),
                                     qvel=torch.where(f, sv, qvel)),
            aux={**state.aux, "delay_started": started & ~fire,
                 "delay_t0": t0})

    def _ctrl(self, state, action):
        return state.phys.qvel[:, 6:8] + action * WHEEL_SPEED_DELTA_MAX

    def _post_terminate(self, state, terminated):
        return state

    def step(self, state: EnvState, action, uniforms=None):
        """One control step of every env.

        action (B, 2) in [-1, 1]; uniforms (B, 6) replaces the launch draws.
        Returns (state, obs float32, reward, terminated, truncated)."""
        with span("env03.step"):
            n = action.shape[0]
            u = self._uniform(n, 6) if uniforms is None else uniforms.to(
                self.device, self.dtype)
            noise = self._noise(n, 4)
            state = self._update_targets(state)
            # 1) reward from the pre-step state
            reward = self._reward(state, noise[:, 0])
            # 2) 250 substeps of the 14-dof scene at constant ctrl
            ctrl = self._ctrl(state, action.to(self.device, self.dtype))
            phys = PhysState14(*control_step14(
                state.phys.qpos, state.phys.qvel, state.phys.warmstart, ctrl,
                self.params))
            state = state._replace(phys=phys, t=state.t + 1)
            # 3) block events on the post-step state and time
            with span("env03.events"):
                state = self._events(state, u)
            # 4) terminate at |pitch| > 50 deg
            terminated = self._pitch(state, state.phys.qpos,
                                     noise[:, 1]).abs() > TERMINATE_PITCH
            state = self._post_terminate(state, terminated)
            # 5) obs from the post-step state
            state, obs = self._obs(state, noise[:, 2:])
            truncated = state.t >= self.max_episode_steps
            return state, obs, reward, terminated, truncated


class Env03V2(Env03V1):
    """Blocks always at the front or always at the back face (chosen once
    per env instance, reference env03_v2.py:22), 7.5 m/s, every 0.5 s,
    tighter aim. Registered with max_episode_steps = 1200."""

    id = "Env03-v2"
    max_episode_steps = 1200
    block_delay = 0.5
    block_speed = 7.5
    # P(a slot is attacked from the back): each slot draws one uniform when
    # it is first reset and is attacked from the front where the draw
    # exceeds it (`envs/hardened.py` changes it for training)
    back_frac = 0.5

    def _init_aux(self, n):
        aux = super()._init_aux(n)
        aux["attack_front"] = self._uniform(n) > self.back_frac
        return aux

    def carry_across_reset(self, old_state, new_state):
        """The attack side belongs to the env instance, not the episode."""
        return new_state._replace(
            aux={**new_state.aux,
                 "attack_front": old_state.aux["attack_front"]})

    def _attack_angle(self, state, u):
        angle = -yaw_of(state.phys.qpos)
        return torch.where(state.aux["attack_front"], angle,
                           angle + torch.pi)

    def _attack_hint(self, state):
        return torch.where(state.aux["attack_front"], 1.0, -1.0)

    def _target_jitter(self):
        return 0.01, 0.13, 0.025   # env03_v2.py:41-45


class Env03V1Fail(Env03V1):
    """As v1, and the motors are cut once the robot has fallen
    (env03_v1_fail.py:37-42)."""

    id = "Env03-v1-fail"

    def _init_aux(self, n):
        aux = super()._init_aux(n)
        aux["fallen"] = self._zeros(n, torch.bool)
        return aux

    def _ctrl(self, state, action):
        ctrl = super()._ctrl(state, action)
        return torch.where(state.aux["fallen"].unsqueeze(-1),
                           torch.zeros_like(ctrl), ctrl)

    def _post_terminate(self, state, terminated):
        return state._replace(
            aux={**state.aux, "fallen": state.aux["fallen"] | terminated})
