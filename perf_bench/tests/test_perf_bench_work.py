"""The roofline and mfu arithmetic on the frozen work files: the tests
read the frozen data, never a live count, so a later kernel change cannot
move them."""

import pytest

from perf_bench import core, readers


def data_of(cell, kernel_s, rate_name=None, rate=None):
    work = core.work_of(cell)
    trace = dict(device_ops=[(work["kernel_name"], 0.0, kernel_s)] * 3,
                 start_s=0.0, window_s=1.0, busy_s=0.5)
    return dict(trace=trace, work=work, peak=core.peak(),
                e2e={rate_name: rate} if rate_name else {},
                window=dict(seconds=1.0, steps=1))


def test_the_peak_is_the_data_sheet_fp32():
    assert core.peak()["fp32_flops_per_s"] == 67.0e12


@pytest.mark.parametrize("cell", ["env01v2.rollout", "env03v2.eval"])
def test_roofline_is_frozen_work_over_peak_over_time(cell):
    work = core.work_of(cell)
    d = data_of(cell, 0.030)
    expect = 100.0 * work["kernel_ops_per_env"] * work["batch"] / 67.0e12 \
        / 0.030
    assert readers.roofline_percent(d) == pytest.approx(expect)
    # twice as fast reads twice as high: the work does not follow the time
    assert readers.roofline_percent(data_of(cell, 0.015)) == \
        pytest.approx(2 * expect)
    assert 0.0 < expect < 100.0


def test_mfu_of_the_rollout():
    work = core.work_of("env01v2.rollout")
    d = data_of("env01v2.rollout", 0.03, "env_steps_per_s", 125000.0)
    per_step = work["kernel_ops_per_env"] + work["policy_flops_per_env_step"]
    assert readers.mfu_percent(d, "env_steps_per_s", (
        "kernel_ops_per_env", "policy_flops_per_env_step")) == \
        pytest.approx(100.0 * per_step * 125000.0 / 67.0e12)


def test_readers_return_nothing_without_their_data():
    d = data_of("env01v2.rollout", 0.03)
    assert readers.mfu_percent(d, "env_steps_per_s", (
        "kernel_ops_per_env",)) is None
    d["trace"]["device_ops"] = []
    assert readers.roofline_percent(d) is None


@pytest.mark.parametrize("cell", ["env01v2.rollout", "env03v2.eval",
                                  "env03v2.interactive"])
def test_a_listed_metric_that_reads_nothing_fails_the_run(cell):
    """A traced run whose trace holds no launch of the cell's kernel (as
    after a rename) fails, naming the metric, instead of leaving it out."""
    from perf_bench import run
    bench = core.benchmark()
    d = data_of(cell, 0.03, "env_steps_per_s", 1000.0)
    d["window"].update(traced_steps=3, step_s=[0.03] * 3)
    d["e2e"]["step_ms_p95"] = 30.0
    assert set(run.per_layer(bench, cell, d)) == {
        m["name"] for m in core.metrics_of_cell(bench, cell, "per_layer")}
    d["trace"]["device_ops"] = [("renamed_kernel", 0.0, 0.03)] * 3
    with pytest.raises(run.MissingMetric, match="found nothing"):
        run.per_layer(bench, cell, d)
