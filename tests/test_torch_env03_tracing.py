"""Env03's spans and launch tally (`envs/env03.py`).

Under a `torch.profiler` session one Env03-v1 step stores `env03.step`
with `env03.events` inside it, and the tally folded into
`profiling.counters()` counts that step's block launches and env-steps;
without one it stores nothing, leaves the tally as it was and gives the
same outputs. The physics is a cheap fake here (the plain 14-dof step
would record every op of 250 substeps under a CPU profiler).
"""

import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import env03
from balance_robot_tpu_torch.utils import profiling

B = 4
PARKED = (0, 2)


def still_block(qpos, qvel, ws, ctrl, params, frame_skip=250):
    """Nothing moves; the blocks in flight keep their speed."""
    return qpos.clone(), qvel.clone(), ws


@pytest.fixture
def store():
    profiling.clear()
    yield profiling
    profiling.clear()


def one_step(monkeypatch, traced):
    """One step of B envs whose blocks in rows PARKED wait to be fired."""
    monkeypatch.setattr(env03, "control_step14", still_block)
    env = brt.make("Env03-v1", device="cpu", seed=5)
    state, _ = env.reset(B)
    started = torch.zeros(B, dtype=torch.bool)
    started[list(PARKED)] = True
    state = state._replace(aux={**state.aux, "delay_started": started})
    action = torch.tensor([[0.5, 0.1], [-0.2, 0.3], [0.9, -0.7], [0.0, 0.0]])
    u = torch.rand((B, 6), generator=torch.Generator().manual_seed(3))
    if not traced:
        return env.step(state, action, u)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return env.step(state, action, u)


def launches(store):
    c = store.counters()
    return c.get("env03.block_launches"), c.get("env03.env_steps")


def test_a_traced_step_stores_its_spans_and_counts_its_launches(
        store, monkeypatch):
    out = one_step(monkeypatch, True)
    spans = store.spans()
    assert [(n, p) for n, p, _, _ in spans] == [("env03.step", None),
                                                ("env03.events", 0)]
    (_, _, s0, s1), (_, _, e0, e1) = spans
    assert s0 <= e0 <= e1 <= s1
    assert not bool(out[0].aux["delay_started"].any())
    assert launches(store) == (len(PARKED), B)
    one_step(monkeypatch, True)
    assert launches(store) == (2 * len(PARKED), 2 * B)


def test_an_untraced_step_stores_and_counts_nothing(store, monkeypatch):
    one_step(monkeypatch, True)
    counted = launches(store)
    store.clear()
    assert launches(store) == (0, 0)
    off = one_step(monkeypatch, False)
    assert store.spans() == []
    assert launches(store) == (0, 0)
    on = one_step(monkeypatch, True)
    assert launches(store) == counted
    for a, b in zip(off[1:], on[1:]):
        assert torch.equal(a, b)
    for a, b in zip(off[0].phys, on[0].phys):
        assert torch.equal(a, b)
    assert torch.equal(off[0].aux["delay_started"],
                       on[0].aux["delay_started"])
