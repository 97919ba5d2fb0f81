"""The readers of the port's section counters (`chain.*`: where a launch
of the cell's kernel spends its time, by section of its chain) on a
synthetic trace and store, on the port's store in this process, and on a
port that keeps no section counters (as the parent of the counters had
none): there they read nothing and raise nothing."""

import pytest

from perf_bench import core, spans

SECTIONS = ("smooth", "contacts", "hessian", "factor", "linesearch",
            "update")
CHAIN = tuple(f"chain.{s}_ms" for s in SECTIONS) + ("chain.imbalance",)
# K2's counters over 2 timed launches of 4 envs: 10 cycles in `smooth`, 20
# in `contacts`, ... summed; the slowest env summed 70 of the 210
COUNTERS = {**{f"k2.cycles.{s}": 10 * (i + 1) for i, s in enumerate(SECTIONS)},
            "k2.cycles.slowest_env": 70, "k2.envs": 4, "k2.rows": 960,
            "k2.coupled_steps": 3, "k2.timed_launches": 2}


def data_of(cell, kernel_s):
    """A traced run's data whose span holds 3 launches of the cell's kernel
    of `kernel_s` each."""
    work = core.work_of(cell)
    trace = dict(device_ops=[(work["kernel_name"], 0.0, kernel_s)] * 3,
                 start_s=0.0, window_s=1.0, busy_s=0.5)
    return dict(trace=trace, work=work, peak=core.peak(), e2e={},
                window=dict(seconds=1.0, steps=1))


@pytest.fixture
def store(monkeypatch):
    """The port's store, holding COUNTERS."""
    monkeypatch.setattr(spans, "store", lambda: ([], dict(COUNTERS)))


@pytest.mark.parametrize("i,name", enumerate(SECTIONS))
def test_a_section_is_its_share_of_the_median_launch(store, i, name):
    value = core.metric_reader(f"chain.{name}_ms").read(
        data_of("env03v2.eval", 0.021))
    assert value == pytest.approx(21.0 * 10 * (i + 1) / 210)


def test_the_sections_sum_to_the_median_launch(store):
    d = data_of("env03v2.interactive", 0.024)
    assert sum(core.metric_reader(f"chain.{s}_ms").read(d)
               for s in SECTIONS) == pytest.approx(24.0)


def test_imbalance_is_the_slowest_env_over_the_mean(store):
    # the mean env summed 210 / 4 cycles
    assert core.metric_reader("chain.imbalance").read(
        data_of("env03v2.eval", 0.021)) == pytest.approx(70 / (210 / 4))


@pytest.mark.parametrize("name", CHAIN)
def test_another_kernels_counters_read_nothing(store, name):
    """A cell of K1 finds no `k1.cycles.*` among K2's counters."""
    assert core.metric_reader(name).read(
        data_of("env01v2.rollout", 0.014)) is None


@pytest.mark.parametrize("name", CHAIN)
def test_a_port_without_section_counters_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "store",
                        lambda: ([], {"eval.live_env_steps": 1}))
    assert core.metric_reader(name).read(data_of("env03v2.eval", 0.02)) \
        is None
    monkeypatch.setattr(spans, "store", lambda: None)
    assert core.metric_reader(name).read(data_of("env03v2.eval", 0.02)) \
        is None


@pytest.mark.parametrize("name", CHAIN)
def test_the_ports_store_in_this_process(name):
    """No timed launch ran here (no card), so the port's own store holds no
    section counters: nothing to read."""
    import balance_robot_tpu_torch  # noqa: F401
    assert core.metric_reader(name).read(data_of("env03v2.eval", 0.02)) \
        is None


def test_no_trace_reads_nothing(store):
    d = data_of("env03v2.eval", 0.02)
    d["trace"] = None
    assert core.metric_reader("chain.hessian_ms").read(d) is None
