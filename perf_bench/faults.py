"""Faults planted in the timed path underneath, for the check that each
comes out as not correct: in the CPU tests (`tests/test_perf_bench_faults.py`)
at a tiny size, and on the card at a cell's own size through
`control.py --fault`. Each fault takes `patch(obj, name, value)`, which sets
an attribute for the run (pytest's `monkeypatch.setattr`, or plain
`setattr` in `control.py --fault`).

What each cell can have: a control step that returns its state unchanged
(every cell); half of the batch left out (the physics of half the envs,
where a cell has a batch); an answer altered where it is produced (a
reward, a return, an action, an episode's start). There is no exchange
between chips: every cell runs on one.
"""

import torch

from balance_robot_tpu_torch import cli
from balance_robot_tpu_torch.envs import env01, env03
from balance_robot_tpu_torch.train import evaluation


def unchanged_physics(patch):
    """A control step that returns its state unchanged."""
    patch(env01, "control_step",
                        lambda qpos, qvel, ws, *a, **k: (qpos, qvel, ws))
    patch(env03, "control_step14",
                        lambda qpos, qvel, ws, *a, **k: (qpos, qvel, ws))


def half_batch_physics(patch):
    """The control step of only the first half of the batch; the rest keep
    their state."""
    def half(step):
        def run_half(qpos, qvel, ws, *a, **k):
            out = step(qpos, qvel, ws, *a, **k)
            n = qpos.shape[0] // 2 or 1
            return tuple(torch.cat((o[:n], i[n:])) for o, i in
                         zip(out, (qpos, qvel, ws)))
        return run_half
    patch(env01, "control_step", half(env01.control_step))
    patch(env03, "control_step14", half(env03.control_step14))


def altered_reward(patch):
    """One env's reward altered where it is produced."""
    reward = env01.Env01V1._reward

    def altered(self, state, u):
        r = reward(self, state, u)
        return torch.cat((r[:1] + 1e-2, r[1:]))
    patch(env01.Env01V1, "_reward", altered)


def altered_return(patch):
    detail = evaluation.ChunkedEvaluator.evaluate_detail

    def altered(self, *a, **k):
        rets, lens = detail(self, *a, **k)
        rets = rets.copy()
        rets[0] += 1e-2 * (1 + abs(rets[0]))
        return rets, lens
    patch(evaluation.ChunkedEvaluator, "evaluate_detail",
                        altered)


def altered_reset(patch):
    """One episode's start altered where the reset produces it: the
    robot's wheels already turning."""
    reset = env03.Env03V1.reset

    def altered(self, n):
        state, obs = reset(self, n)
        qvel = state.phys.qvel.clone()
        qvel[0, 6] += 1.0
        return state._replace(phys=state.phys._replace(qvel=qvel)), obs
    patch(env03.Env03V1, "reset", altered)


def altered_action(patch):
    act_of = cli._policy_act

    def altered(params, env):
        act = act_of(params, env)
        return lambda obs: act(obs) + 1e-2
    patch(cli, "_policy_act", altered)


FAULTS = [
    ("env01v2.rollout", unchanged_physics),
    ("env01v2.rollout", half_batch_physics),
    ("env01v2.rollout", altered_reward),
    ("env03v2.eval", unchanged_physics),
    ("env03v2.eval", half_batch_physics),
    ("env03v2.eval", altered_return),
    ("env03v2.eval", altered_reset),
    ("env03v2.interactive", unchanged_physics),
    ("env03v2.interactive", altered_action),
    ("env03v2.interactive", altered_reset),
]
