"""The benchmark's command as the check runs it: it refuses to run without
the card, and without the program beside it; on the card (marked `cuda`)
one short run of a cell prints a result that is correct."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from perf_bench import core

ARGS = ["--workload", "env01v2.rollout", "--seed", "3000000301",
        "--seconds", "3", "--trace", "0"]


def command(cwd, timeout=600):
    return subprocess.run([sys.executable, "perf_bench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = command(core.ROOT)
    assert out.returncode == 2, out.stderr
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()


def test_nothing_but_the_benchmark_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith('{"correct"')
                   for line in out.stdout.splitlines())


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = command(core.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
