"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped): a sound run comes out correct; the control (the reference in
bfloat16 in the program's place) and each fault a cell can have, planted
in the timed path underneath, come out not correct. The physics is the
port's plain version here, as on the CPU the port runs it."""

import pytest

from perf_bench import faults, run

TINY = {
    "env01v2.rollout": dict(n_envs=4, warmup_steps=1, sampled_steps=2),
    "env03v2.eval": dict(n_envs=2, horizon=2, chunk=1, warmup_steps=1,
                         sampled_steps=2),
    "env03v2.interactive": dict(warmup_steps=1, sampled_steps=2),
}
SEED = 3000000211


def cpu_run(cell, control=False):
    return run.run(["--workload", cell, "--seed", str(SEED), "--seconds",
                    "0.1"], device="cpu", overrides=TINY[cell],
                   control=control)


def failed(result):
    return sorted(name for name, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    result = cpu_run(cell)
    assert result["correct"], failed(result)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell):
    result = cpu_run(cell, control=True)
    assert not result["correct"]
    assert failed(result)


@pytest.mark.parametrize("cell,fault", faults.FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in faults.FAULTS])
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = cpu_run(cell)
    assert not result["correct"], result["checks"]
