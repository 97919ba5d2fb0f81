"""Data collection on an Env03 scene, held to the reference where the block
acts: the rollout driver (`rollout.py`: its `setup`, `step` and `window`,
and its numbers), plus two numbers over the envs that a block acts on.

A block fires in about 1% of the envs at a step, so the rollout's 90th
percentiles over all envs cannot see a wrong launch, and the block is not
in the obs; the impacts are held to the reference over the envs where a
block can touch the robot. Over each sampled step:

  launch    the largest gap of the block's pose and linear velocity
            (qpos[9:16], qvel[8:11]) over the envs whose block the
            reference fires in that step. With a delay of 0 or more a block
            never parks and fires in one step, so the reference fires
            exactly where the pre-step state waits (`delay_started`) and
            its post-step state no longer does. Where the program's fire
            decision differs, `flags` counts the env already.
  near_p90  over the envs whose block lies within reach of the robot at
            the pre-step state (`within_reach`), the 90th percentile of
            each env's largest qpos / qvel gap (`check.row_gap_quantile`).

Standard error gets each sampled step's count of envs in each set.
"""

import sys

import torch

from .. import check, program
from ..reference.envs import CONTROL_DT, load
from ..reference.physics import block_step as bs, robot_core as rc
from .rollout import setup, step, window  # noqa: F401  (the cell's loop)
from . import rollout


def _norm(*xs):
    return sum(x * x for x in xs) ** 0.5


def reach_radius():
    """The distance from the robot's body origin (qpos[0:3]) within which
    a block's centre may touch the robot within one control step: the
    farthest point of the chassis box (CHASSIS_OFF +- CHASSIS_HALF) or of a
    wheel (a cylinder of WHEEL_R and half-length WHEEL_H on the x axis at
    wheel_pos) from the origin, plus the block's half-diagonal and contact
    margin, plus one control step's travel at the launch speed (Env03-v1's
    5 m/s). 0.2542 m for the 14-dof scene."""
    chassis = _norm(*(abs(o) + h for o, h in zip(rc.CHASSIS_OFF,
                                                 rc.CHASSIS_HALF)))
    wheel = max(_norm(abs(p[0]) + rc.WHEEL_H, _norm(p[1], p[2]) + rc.WHEEL_R)
                for p in (bs.ENV03_PARAMS.wheel_pos_l,
                          bs.ENV03_PARAMS.wheel_pos_r))
    return (max(chassis, wheel) + _norm(*bs.BLOCK_HALF) + bs.BLOCK_MARGIN
            + load("Env03-v1").block_speed * CONTROL_DT)


REACH = reach_radius()


def within_reach(qpos):
    """(B,) bool: the block's centre within REACH of the robot's origin."""
    return (qpos[:, 9:12] - qpos[:, 0:3]).square().sum(-1).sqrt() <= REACH


class _Keeping:
    """The reference env, keeping the outputs of each of its steps."""

    def __init__(self, env):
        self._env = env
        self.outs = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, *args):
        out = self._env.step(*args)
        self.outs.append(out)
        return out


def compare(ctx, st, res):
    records = st.rec.sampled()
    make = program.reference_env
    kept = []

    def keeping(*args):
        kept.append(_Keeping(make(*args)))
        return kept[-1]

    program.reference_env = keeping
    try:
        numbers = rollout.compare(ctx, st, res)
    finally:
        program.reference_env = make
    # the float64 truth, then (the control) the reference in bfloat16
    outs = kept[0].outs
    truth = outs[0][0]
    cand = (outs[1][0] if ctx.control else
            check.cat([check.program_step(r) for r in records]))
    pre = check.cat([check.state_dict(r["pre"]) for r in records])
    fired = pre["delay_started"] & ~truth["delay_started"]
    near = within_reach(pre["qpos"])
    numbers["launch"] = check.gap(
        torch.cat((cand["qpos"][fired, 9:16], cand["qvel"][fired, 8:11]), -1),
        torch.cat((truth["qpos"][fired, 9:16], truth["qvel"][fired, 8:11]),
                  -1))
    numbers["near_p90"] = check.row_gap_quantile(
        torch.cat((cand["qpos"], cand["qvel"]), -1)[near],
        torch.cat((truth["qpos"], truth["qvel"]), -1)[near])
    B = records[0]["action"].shape[0]
    for r, f, n in zip(records, fired.split(B), near.split(B)):
        print(f"sampled step {r['index']}: {int(f.sum())} of {B} envs fire,"
              f" {int(n.sum())} within reach ({REACH:.4f} m)",
              file=sys.stderr)
    return numbers
