"""Host syncs per step of the B = 1 loop: the `cli.sync.*` spans (one per
sync site) inside the complete `cli.step` spans, over the steps. Read from
the port's span store in this process (`perf_bench/spans.py`, which
imports `balance_robot_tpu_torch.utils.profiling`)."""
from perf_bench import spans


def value(store_spans, counters):
    s = spans.cli_steps(store_spans)
    return None if s is None else s["syncs"] / s["steps"]


def read(data):
    return spans.read(value)
