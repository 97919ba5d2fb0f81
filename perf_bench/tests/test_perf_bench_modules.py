"""The check that no run holds JAX or the JAX package compares whole
top-level module names."""

import subprocess
import sys

import pytest

from perf_bench import core


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax.linen", "balance_robot_tpu",
                                  "balance_robot_tpu.envs.env01"])
def test_forbidden(name):
    assert core.forbidden_modules(["torch", name]) == [name]


@pytest.mark.parametrize("name", ["balance_robot_tpu_torch",
                                  "balance_robot_tpu_torch.physics",
                                  "jaxtyping", "flaxen", "perf_bench"])
def test_allowed(name):
    assert core.forbidden_modules(["torch", name]) == []


def test_the_harness_and_the_port_load_none():
    """In a fresh process: the harness, every driver and what they import
    of the port."""
    code = ("import perf_bench.run, perf_bench.control; "
            "from perf_bench import core; "
            "[core.driver(d) for d in ('rollout', 'eval', 'interactive')]; "
            "import balance_robot_tpu_torch.cli, "
            "balance_robot_tpu_torch.train.selection, "
            "balance_robot_tpu_torch.train.ppo, "
            "balance_robot_tpu_torch.utils.profiling; "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_refused_when_present(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(core.Refused):
        core.require_no_forbidden("test")
