"""The move stack's spans (`envs/move.py`) and K3's launches by team
(`physics/cuda_move.py`).

Under a `torch.profiler` session one EnvMove05-v1 step stores `move.step`
with `move.lidar` and `move.inner` inside it; without one it stores
nothing and gives the same outputs. The physics is a cheap fake here (the
plain wall step would record every op of 250 substeps under a CPU
profiler); the lidar reward and the int8 inner policy are the port's own.
On the card (marked `cuda`), K3's launches are counted under the team that
`KERNEL.launch_config` chose for the batch.
"""

import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import move
from balance_robot_tpu_torch.physics import cuda_move
from balance_robot_tpu_torch.utils import profiling


def fake_walls(qpos, qvel, ws, ctrl, friction, params, frame_skip=250):
    """The wheels take the servo targets; nothing else moves."""
    qv = qvel.clone()
    qv[:, 6:8] = ctrl
    return qpos.clone(), qv, ws


@pytest.fixture
def store():
    profiling.clear()
    yield profiling
    profiling.clear()


def one_step(monkeypatch, traced):
    monkeypatch.setattr(move, "control_step", fake_walls)
    env = brt.make("EnvMove05-v1", device="cpu", seed=5)
    state, _ = env.reset(3)
    action = torch.tensor([[0.5, 0.1], [-0.2, 0.3], [0.9, -0.7]])
    if not traced:
        return env.step(state, action)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return env.step(state, action)


def test_a_traced_step_stores_its_spans_nested(store, monkeypatch):
    one_step(monkeypatch, True)
    spans = store.spans()
    assert [(n, p) for n, p, _, _ in spans] == [
        ("move.step", None), ("move.lidar", 0), ("move.inner", 0)]
    (_, _, s0, s1), (_, _, l0, l1), (_, _, i0, i1) = spans
    assert s0 <= l0 <= l1 <= i0 <= i1 <= s1


def test_an_untraced_step_stores_nothing_and_gives_the_same(store,
                                                           monkeypatch):
    off = one_step(monkeypatch, False)
    assert store.spans() == []
    on = one_step(monkeypatch, True)
    for a, b in zip(off[1:], on[1:]):
        assert torch.equal(a, b)
    for a, b in zip(off[0].phys, on[0].phys):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_launches_are_counted_by_team_on_the_card(monkeypatch):
    """K3 at B = 1 (the team of lanes below the crossover) and at the
    crossover (one lane per env), float32, a short step each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K3)")
    monkeypatch.setattr(cuda_move.KERNEL, "launches_by_team", {})
    X, = cuda_move.KERNEL.crossovers()
    teams = []
    for B in (1, X, X):
        qpos = torch.zeros(B, 9, device="cuda")
        qpos[:, 3] = 1.0
        qpos[:, 2] = -0.0205
        zeros = torch.zeros(B, 8, device="cuda")
        cuda_move.control_step_walls(qpos, zeros, zeros.clone(),
                                     torch.zeros(B, 2, device="cuda"),
                                     move.MOVE05_PARAMS, frame_skip=5)
        teams.append(cuda_move.KERNEL.launch_config(torch.float32, B)[0])
    torch.cuda.synchronize()
    assert teams[0] > 1 and teams[1] == 1
    assert cuda_move.KERNEL.launches_by_team == {teams[0]: 1, 1: 2}
