"""Env03-v2: Env01's robot while a 4 cm block is fired at it (the reference
project's envs/env03_v1.py and env03_v2.py), stepped by the plain physics of
the 14-dof scene."""

import torch

from . import (PARK_POS, PITCH_MAX, SPAWN_RADIUS, SPAWN_Z, TERMINATE_PITCH,
               base_reward, bfloat16_state, euler_quat_scrambled, load,
               observe, pitch_of, time_of, yaw_of)
from ..physics import block_step as bs, with_grade

Env01V2 = load("Env01-v2")


class Env03V2(Env01V2):
    """Balance while a 4 cm block is fired at the robot's front or back
    face (chosen once per env) at 7.5 m/s, 0.5 s after it came to rest."""

    id = "Env03-v2"
    nq, nv, n_uniforms = 16, 14, 6
    max_episode_steps = 1200
    block_delay = 0.5
    block_speed = 7.5
    jitter = (0.01, 0.13, 0.025)     # aim: x half-range, z low, z range

    def __init__(self, solver):
        self.params = with_grade(bs.ENV03_PARAMS, solver)

    def _pitch(self, qpos, u):
        return pitch_of(qpos)

    def physics(self, qpos, qvel, ws, ctrl, frame_skip=250):
        if qpos.dtype == torch.bfloat16:
            return bfloat16_state(self.physics, qpos, qvel, ws, ctrl)
        s = bs.control_step14(bs.PhysState14(qpos, qvel, ws), ctrl,
                              self.params, frame_skip=frame_skip)
        return s.qpos, s.qvel, s.warmstart

    def spawn(self, qpos, qvel, attack_front, u):
        """The block on the 0.3 m circle around the robot, flying at the
        aim point (set_block_pos_vel)."""
        robot = qpos[:, 0:3]
        angle = -yaw_of(qpos)
        angle = torch.where(attack_front, angle, angle + torch.pi)
        block_pos = torch.stack((
            SPAWN_RADIUS * torch.sin(angle) + robot[:, 0],
            SPAWN_RADIUS * torch.cos(angle) + robot[:, 1],
            torch.full_like(angle, SPAWN_Z)), -1)
        jx, zlo, zrange = self.jitter
        target = torch.stack(((u[:, 1] - 0.5) * 2 * jx + robot[:, 0],
                              robot[:, 1], u[:, 2] * zrange + zlo), -1)
        v = target - block_pos
        v = self.block_speed * v / v.square().sum(-1, keepdim=True).sqrt()
        rot = u[:, 3:6] * 2 * torch.pi
        quat = euler_quat_scrambled(rot[:, 0], rot[:, 1], rot[:, 2])
        return (torch.cat((qpos[:, :9], block_pos, quat), -1),
                torch.cat((qvel[:, :8], v, qvel[:, 11:]), -1))

    def events(self, post, u):
        """Park the block once slower than 0.1 m/s; fire it again after the
        delay. Returns (state, margin of the park decision in m/s)."""
        qpos, qvel = post["qpos"], post["qvel"]
        t = time_of(post["t"])
        speed = qvel[:, 8:11].square().sum(-1).sqrt()
        was_parked = started = post["delay_started"]
        park = (speed < 0.1) & ~started
        park_pos = torch.tensor(PARK_POS, dtype=qpos.dtype,
                                device=qpos.device)
        qpos = torch.cat((qpos[:, :9], torch.where(
            park.unsqueeze(-1), park_pos, qpos[:, 9:12]), qpos[:, 12:]), -1)
        t0 = torch.where(park, t, post["delay_t0"])
        started = started | park
        fire = started & ((t - t0) > self.block_delay)
        sq, sv = self.spawn(qpos, qvel, post["attack_front"], u)
        f = fire.unsqueeze(-1)
        post = dict(post, qpos=torch.where(f, sq, qpos),
                    qvel=torch.where(f, sv, qvel),
                    delay_started=started & ~fire, delay_t0=t0)
        # the speed decides nothing where the block was already parked
        margin = torch.where(was_parked,
                             torch.full_like(speed, float("inf")),
                             (speed - 0.1).abs())
        return post, margin

    def fresh(self, s, obs):
        """As Env01-v2's, for the robot's part (no pitch noise); the block
        is in flight from its spawn."""
        q, j = s["qpos"], self.reset_jitter + 1e-6
        pitch = pitch_of(q)
        return ((s["t"] == 0) & (s["qvel"][:, :8] == 0).all(-1)
                & (s["qvel"][:, 11:] == 0).all(-1) & (s["ws"] == 0).all(-1)
                & (q[:, 0:2].abs() <= j).all(-1) & (q[:, 2] == 0)
                & (q[:, 7:9].abs() <= j).all(-1)
                & ((q[:, 3:7].square().sum(-1) - 1).abs() <= 1e-5)
                & (s["last_t"] == 0) & s["has_last"]
                & ((obs[:, 0] * PITCH_MAX - pitch).abs() <= 1e-5)
                & (obs[:, 1:] == 0).all(-1) & ~s["delay_started"])

    def step(self, state, action, u, phys=None):
        reward = base_reward(state["qvel"], pitch_of(state["qpos"]))
        if phys is None:
            phys = self.physics(state["qpos"], state["qvel"], state["ws"],
                                self.ctrl(state, action))
        post = dict(state, qpos=phys[0], qvel=phys[1], ws=phys[2],
                    t=state["t"] + 1)
        post, park_margin = self.events(post, u)
        pitch = pitch_of(post["qpos"]).abs()
        terminated = pitch > TERMINATE_PITCH
        obs, slots = observe(post, pitch_of(post["qpos"]),
                             pitch_of(post["qpos"]))
        post.update(slots)
        truncated = post["t"] >= self.max_episode_steps
        margin = torch.minimum((pitch - TERMINATE_PITCH).abs(),
                               park_margin.to(pitch.dtype))
        return post, obs, reward, terminated, truncated, margin


ENV = Env03V2
