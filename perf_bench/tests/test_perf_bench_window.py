"""The window's arithmetic: rates to a boundary, tails over every step,
merged busy intervals, the idle gaps and their names, the sample of
steps."""

import pytest

from perf_bench import readers, tracing, window as win


def test_rate_counts_all_work_over_the_whole_window():
    # 37 steps of 4096 envs in a window that closed 10.4 s after it opened
    assert win.rate(37 * 4096, 10.4) == pytest.approx(14572.307692307691)
    with pytest.raises(ValueError):
        win.rate(1, 0.0)


def test_percentile_is_over_every_step_by_nearest_rank():
    steps = [0.030] * 95 + [0.050] * 4 + [0.200]
    assert win.percentile(steps, 95) == 0.030
    assert win.percentile(steps + [0.060], 95) == 0.050
    assert win.percentile([1.0], 95) == 1.0
    assert win.percentile(list(range(1, 21)), 95) == 19


def test_intervals_and_median():
    assert win.intervals_between([0.0, 0.5, 1.5, 1.75]) == [0.5, 1.0, 0.25]
    assert win.median([3.0, 1.0, 2.0]) == 2.0
    assert win.median([4.0, 1.0, 3.0, 2.0]) == 2.5


def test_merged_length_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert win.merged_length(iv) == 3.0
    assert win.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert win.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_reservoir_is_seeded_and_uniform():
    def kept(seed):
        r = win.Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        return sorted(r.kept)
    assert kept(7) == kept(7) and kept(7) != kept(8)
    counts = [0] * 10
    for seed in range(2000):
        for i in kept(seed):
            counts[i // 100] += 1
    assert min(counts) > 0.8 * 800 and max(counts) < 1.2 * 800


def trace_events():
    span = dict(name=tracing.SPAN, cat="user_annotation", ts=1000, dur=1000)
    return [span,
            dict(name="control_step_kernel", cat="kernel", ts=1100, dur=300),
            dict(name="control_step_kernel", cat="kernel", ts=1500, dur=100),
            dict(name="Memcpy DtoH", cat="gpu_memcpy", ts=1550, dur=100),
            dict(name="before", cat="kernel", ts=900, dur=150),
            dict(name="aten::add", cat="cpu_op", ts=1400, dur=50),
            dict(name="cudaStreamSynchronize", cat="cuda_runtime", ts=1660,
                 dur=330),
            dict(name="step", cat="user_annotation", ts=1010, dur=980)]


def test_read_events_merges_and_names_the_gaps():
    t = tracing.read_events(trace_events())
    assert t["window_s"] == pytest.approx(1e-3)
    # 1000-1050 (clipped), 1100-1400, 1500-1650: 500 us busy
    assert t["busy_s"] == pytest.approx(500e-6)
    assert t["top_ops"][0] == ["control_step_kernel", pytest.approx(400e-6)]
    idle = dict(t["idle_gaps"])
    # 1650-2000 waits in the sync, 1050-1100 in the step, 1400-1500 ends
    # the add at its middle
    assert idle["cudaStreamSynchronize"] == pytest.approx(350e-6)
    assert idle["step"] == pytest.approx(50e-6)
    assert idle["aten::add"] == pytest.approx(100e-6)
    assert sorted(tracing.kernel_times(t, "control_step_kernel")) == [
        pytest.approx(100e-6), pytest.approx(300e-6)]


def test_idle_share_and_host_time_per_step():
    t = tracing.read_events(trace_events())
    data = dict(trace=t, work=dict(kernel_name="control_step_kernel"),
                window=dict())
    assert readers.idle_percent(data) == pytest.approx(50.0)
    assert readers.kernel_seconds(data) == pytest.approx(200e-6)
    # (1000 us of span - 400 us of the kernel) / 4 steps
    assert readers.host_ms_per_step(
        dict(data, window=dict(traced_steps=4))) == pytest.approx(0.15)
    # a launch the trace records twice, and one across the span's end,
    # count only their time inside the span, once
    t["device_ops"] += [("control_step_kernel", 1100e-6, 300e-6),
                        ("control_step_kernel", 1900e-6, 500e-6)]
    assert readers.host_ms_per_step(
        dict(data, window=dict(traced_steps=4))) == pytest.approx(0.125)
    assert readers.kernel_seconds(dict(data, trace=None)) is None
