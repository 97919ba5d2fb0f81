"""Env03-v1: Env01's robot while a 4 cm block is fired at it from every
direction (the reference project's __init__.py Env03-v1 and
envs/env03_v1.py:17-114), stepped by the plain physics of the 14-dof scene.

What differs from Env03-v2 (`Env03-v2.py`, whose step, events and physics
this reuses):
  * each launch draws its direction, u[:, 0] x 2 pi, on the 0.3 m circle
    around the robot (env03_v1.py:88-114), where v2 fires at the front or
    back face the env chose once;
  * 5 m/s, aimed at a point jittered by x +-0.03, z 0.1 + [0, 0.075]
    (env03_v1.py:96-100);
  * no delay: a block parked once slower than 0.1 m/s fires again at the
    next control step (env03_v1.py:39-49, the delay 0 read as "more than 0
    s since the park");
  * the registered horizon, 6000 steps; no attack side in the state.

Departures from the reference project, each as the port has it:
  * the reset's chassis quaternion is scipy's [x, y, z, w] written raw into
    MuJoCo's [w, x, y, z] slots, the reference's quirk, kept (the block's
    orientation at each launch likewise);
  * the spawn height is float32(0.15), as the reference writes it;
  * time is float32 (t x 5 ms), as the reference's MuJoCo time read back as
    float32 is.
"""

import math

import torch

from . import SPAWN_RADIUS, SPAWN_Z, euler_quat_scrambled, load

Env03V2 = load("Env03-v2")

# the reset's euler ranges (env03_v1.py:67-70): y and z within +-0.2 rad
RESET_YZ = 0.2
# the aim's largest sideways offset (0.03 m) seen from the spawn circle less
# that offset: the widest angle between a launch and the line to the robot
AIM_ANGLE = math.atan2(0.03, SPAWN_RADIUS - 0.03)
# the tolerance of the reset's checks on a float32 program's values
FRESH_TOL = 1e-5


def true_euler_yz(q):
    """Extrinsic xyz euler y, z of the rotation whose scrambled quaternion
    (the reset's quirk) is `q` (B, 4) in MuJoCo's slots."""
    x, y, z, w = q.unbind(-1)
    n = (w * w + x * x + y * y + z * z).clamp_min(1e-30)
    r20 = 2 * (x * z - w * y) / n
    r10 = 2 * (x * y + w * z) / n
    r00 = 1 - 2 * (y * y + z * z) / n
    return torch.asin((-r20).clamp(-1.0, 1.0)), torch.atan2(r10, r00)


class Env03V1(Env03V2):
    """Balance while a 4 cm block is fired at the robot from a random
    direction at 5 m/s, again as soon as it has come to rest."""

    id = "Env03-v1"
    max_episode_steps = 6000
    block_delay = 0.0
    block_speed = 5.0
    jitter = (0.03, 0.1, 0.075)

    def __init__(self, solver):
        # a float32 product on the card may otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(solver)

    def spawn(self, qpos, qvel, attack_front, u):
        """v2's spawn with the launch's own direction, u[:, 0] x 2 pi."""
        robot = qpos[:, 0:3]
        angle = u[:, 0] * 2 * torch.pi
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
        """v2's park and fire; v1's state has no attack side to hand the
        spawn."""
        post, margin = super().events(dict(post, attack_front=None), u)
        del post["attack_front"]
        return post, margin

    def fresh(self, s, obs):
        """v2's check of the robot's part, the reset's euler ranges, and the
        block just fired: on the 0.3 m circle around the robot at z =
        float32(0.15), flying at 5 m/s towards it, unit quaternion."""
        q, v = s["qpos"], s["qvel"]
        ey, ez = true_euler_yz(q[:, 3:7])
        rel = q[:, 9:11] - q[:, 0:2]
        dist = rel.square().sum(-1).sqrt()
        speed = v[:, 8:11].square().sum(-1).sqrt()
        vh = v[:, 8:10]
        inward = -(rel * vh).sum(-1) / (dist * vh.square().sum(-1).sqrt()
                                         ).clamp_min(1e-30)
        return (super().fresh(s, obs)
                & (ey.abs() <= RESET_YZ + FRESH_TOL)
                & (ez.abs() <= RESET_YZ + FRESH_TOL)
                & ((dist - SPAWN_RADIUS).abs() <= FRESH_TOL)
                & (q[:, 11] == SPAWN_Z)
                & ((speed - self.block_speed).abs() <= FRESH_TOL * 5)
                & (inward >= math.cos(AIM_ANGLE) - FRESH_TOL)
                & ((q[:, 12:16].square().sum(-1) - 1).abs() <= FRESH_TOL))


ENV = Env03V1
