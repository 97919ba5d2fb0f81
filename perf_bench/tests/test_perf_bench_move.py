"""The move cell (`envmove05.rollout`) on the CPU at a tiny size: a sound
run comes out correct; the control and each fault planted in the move
stack (`faults_move.py`) do not. The readers of its per-layer metrics on
made-up data, and its frozen work."""

import pytest

from perf_bench import core, faults_move, readers, run

CELL = "envmove05.rollout"
TINY = dict(n_envs=4, warmup_steps=1, sampled_steps=2)
SEED = 3000000211
MS = 1_000_000


def cpu_run(control=False):
    return run.run(["--workload", CELL, "--seed", str(SEED), "--seconds",
                    "0.1"], device="cpu", overrides=TINY, control=control)


def failed(result):
    return sorted(name for name, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


def test_a_sound_run_is_correct():
    result = cpu_run()
    assert result["correct"], failed(result)
    assert result["attempted"] >= TINY["n_envs"]


def test_the_control_fails_a_limit():
    result = cpu_run(control=True)
    assert not result["correct"]
    assert failed(result)


@pytest.mark.parametrize("fault", faults_move.FAULTS,
                         ids=[f.__name__ for f in faults_move.FAULTS])
def test_a_fault_in_the_move_stack_is_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = cpu_run()
    assert not result["correct"], result["checks"]


def host_reader():
    module = core.metric_reader("move.host_ms_per_step")
    assert module is not None
    return module


def test_host_ms_per_step_on_a_made_up_store():
    # the step cut by the profiler's stop (no end) and other spans do not
    # count; the two whole steps take 20 and 30 ms
    store = [("move.step", None, 0, 20 * MS),
             ("move.lidar", 0, 1 * MS, 2 * MS),
             ("move.inner", 0, 3 * MS, 4 * MS),
             ("cli.step", None, 25 * MS, 90 * MS),
             ("move.step", None, 100 * MS, 130 * MS),
             ("move.step", None, 140 * MS, None)]
    assert host_reader().value(store, {}) == pytest.approx(25.0,
                                                           rel=1e-12)


def test_host_ms_per_step_reads_nothing_without_its_spans(monkeypatch):
    assert host_reader().value([], {}) is None
    assert host_reader().value([("move.step", None, 0, None)], {}) is None
    from balance_robot_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert host_reader().read({}) is None


def traced_data(kernel_s, rate):
    work = core.work_of(CELL)
    # three launches back to back, 1 ms apart
    trace = dict(device_ops=[(work["kernel_name"], i * (kernel_s + 0.001),
                              kernel_s) for i in range(3)],
                 start_s=0.0, window_s=3 * (kernel_s + 0.001),
                 busy_s=3 * kernel_s)
    return dict(trace=trace, work=work, peak=core.peak(),
                e2e={"env_steps_per_s": rate},
                window=dict(seconds=1.0, steps=3, traced_steps=3))


def test_the_cells_metrics_on_its_frozen_work():
    work = core.work_of(CELL)
    assert work["kernel_name"] == "control_step_walls_kernel"
    assert work["batch"] == 4096
    assert work["kernel_ops_min"] <= work["kernel_ops_per_env"] \
        <= work["kernel_ops_max"]
    assert work["policy_flops_per_env_step"] == 2 * (10 * 64 + 64 * 64
                                                     + 64 * 2)
    assert work["inner_policy_ops_per_env_step"] == 2 * (6 * 64 + 64 * 64
                                                         + 64 * 2)
    d = traced_data(0.025, 150000.0)
    roof = core.metric_reader("k3.roofline").read(d)
    assert roof == pytest.approx(readers.roofline_percent(d))
    assert 0.0 < roof < 100.0
    per_step = work["kernel_ops_per_env"] + work[
        "policy_flops_per_env_step"] + work["inner_policy_ops_per_env_step"]
    assert core.metric_reader("mfu.move").read(d) == pytest.approx(
        100.0 * per_step * 150000.0 / core.peak()["fp32_flops_per_s"])
    # 3 launches of 25 ms in a window of 78 ms: 1 ms per step outside K3
    assert core.metric_reader("move.overhead_ms_per_step").read(
        d) == pytest.approx(1.0)


def test_the_listed_metrics_fail_the_run_when_k3_is_renamed():
    bench = core.benchmark()
    listed = {m["name"] for m in core.metrics_of_cell(bench, CELL,
                                                      "per_layer")}
    assert {"k3.roofline", "mfu.move",
            "move.overhead_ms_per_step"} <= listed
    d = traced_data(0.025, 150000.0)
    assert set(run.per_layer(bench, CELL, d)) == listed
    d["trace"]["device_ops"] = [("renamed_kernel", 0.0, 0.025)] * 3
    with pytest.raises(run.MissingMetric, match="found nothing"):
        run.per_layer(bench, CELL, d)
