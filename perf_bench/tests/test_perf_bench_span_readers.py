"""The readers of the port's own spans and counters (`spans.py`, the
metrics that use it) on synthetic stores, on an empty one, on the port's
store in this process, and on a port that keeps none."""

import pytest

from perf_bench import core, spans

SPAN_METRICS = ("cli.self_ms_per_step", "cli.wait_ms_per_step",
                "cli.syncs_per_step", "eval.live_share", "setup.import_s",
                "setup.kernel_s")
MS = 1_000_000

# (name, parent, start_ns, end_ns): the first step is cut at its start (its
# syncs have no stored step), the last by the profiler's stop (no end)
STORE = [
    ("setup.import", None, 0, 900 * MS),
    ("kernel.load", None, 1000 * MS, 1200 * MS),
    ("kernel.first_launch", None, 1300 * MS, 1350 * MS),
    ("cli.sync.reward", None, 1990 * MS, 1999 * MS),
    ("cli.step", None, 2000 * MS, 2040 * MS),                 # 4
    ("cli.sync.obs", 4, 2000 * MS, 2001 * MS),
    ("cli.act", 4, 2001 * MS, 2005 * MS),                     # 6
    ("cli.sync.policy_in", 6, 2001 * MS, 2002 * MS),
    ("cli.sync.policy_out", 6, 2003 * MS, 2004 * MS),
    ("cli.env_step", 4, 2005 * MS, 2008 * MS),
    ("cli.sync.reward", 4, 2008 * MS, 2038 * MS),
    ("cli.step", None, 2040 * MS, 2060 * MS),                 # 11
    ("cli.sync.obs", 11, 2040 * MS, 2042 * MS),
    ("cli.sync.reward", 11, 2045 * MS, 2055 * MS),
    ("cli.sync.term", 11, 2055 * MS, 2056 * MS),
    ("cli.step", None, 2060 * MS, None),                      # 15
    ("cli.sync.obs", 15, 2060 * MS, 2061 * MS),
]
COUNTERS = {"eval.live_env_steps": 900, "eval.stepped_env_steps": 1200}
EXPECTED = {
    # steps 40 + 20 ms; syncs 1 + 1 + 1 + 30 and 2 + 10 + 1 ms
    "cli.self_ms_per_step": (60 - 33 - 13) / 2,
    "cli.wait_ms_per_step": (33 + 13) / 2,
    "cli.syncs_per_step": 7 / 2,
    "eval.live_share": 75.0,
    "setup.import_s": 0.9,
    "setup.kernel_s": 0.25,
}


def reader(name):
    module = core.metric_reader(name)
    assert module is not None, name
    return module


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_synthetic_store(name):
    assert reader(name).value(STORE, COUNTERS) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_an_empty_store_reads_nothing(name):
    assert reader(name).value([], {}) is None


def test_a_store_of_open_steps_only_reads_nothing():
    assert spans.cli_steps([("cli.step", None, 0, None),
                            ("cli.sync.obs", 0, 0, 1)]) is None
    assert reader("eval.live_share").value(
        [], {"eval.stepped_env_steps": 0, "eval.live_env_steps": 0}) is None


def test_the_ports_store_in_this_process():
    import balance_robot_tpu_torch  # noqa: F401
    found = spans.store()
    assert found is not None and isinstance(found[1], dict)
    assert reader("setup.import_s").read({}) == reader(
        "setup.import_s").value(*found)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_port_without_a_store_reads_nothing(name, monkeypatch):
    from balance_robot_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read({}) is None
