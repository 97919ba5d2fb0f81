"""Faults planted in Env03-v1's launches, respawns and impacts (the port's
`envs/env03.py` and what it runs), for the check that each comes out as not
correct: in the CPU tests (`tests/test_perf_bench_env03v1.py`) at a tiny
size, and on the card at `env03v1.rollout`'s size through `control.py
--fault` once `faults.py` is given the fault (`python -c "from perf_bench
import control, faults, faults_env03v1 as f; faults.front_launch =
f.front_launch; control.main([...])"`). Each fault takes `patch(obj, name,
value)`, as `faults.py`'s do; FAULTS pairs each with the numbers it fails.
"""

import torch

from balance_robot_tpu_torch.envs import env03
from balance_robot_tpu_torch.envs.base import yaw_of

from .drivers.rollout_block import within_reach


def front_launch(patch):
    """Every launch at the robot's front face (Env03-v2's angle), not from
    the launch's own direction."""
    patch(env03.Env03V1, "_attack_angle",
          lambda self, state, u: -yaw_of(state.phys.qpos))


def respawn_delay(patch):
    """A parked block fired 0.5 s later (Env03-v2's delay), not at the next
    step."""
    patch(env03.Env03V1, "block_delay", 0.5)


def slow_launch(patch):
    """The block fired at 4.5 m/s, not 5."""
    patch(env03.Env03V1, "block_speed", 4.5)


def impact_dropped(patch):
    """The control step of the envs whose block is within reach run with
    the block parked out of the way, then its pre-step pose put back: the
    robot never feels the block."""
    step = env03.control_step14

    def dropped(qpos, qvel, ws, *a, **k):
        near = within_reach(qpos).unsqueeze(-1)
        park = torch.tensor(env03.PARK_POS, dtype=qpos.dtype,
                            device=qpos.device)
        moved = torch.cat((qpos[:, :9], park.expand(qpos.shape[0], 3),
                           qpos[:, 12:]), -1)
        out_q, out_v, out_ws = step(torch.where(near, moved, qpos), qvel, ws,
                                    *a, **k)
        out_q = torch.cat((out_q[:, :9], torch.where(
            near, qpos[:, 9:16], out_q[:, 9:16])), -1)
        return out_q, out_v, out_ws
    patch(env03, "control_step14", dropped)


FAULTS = [(front_launch, {"launch"}),
          (respawn_delay, {"launch", "flags"}),
          (slow_launch, {"launch"}),
          (impact_dropped, {"near_p90"})]
