"""ms per step of the B = 1 loop's own host work (Python, launches, Env03's
enqueue; `cli._run_episodes` and `_policy_act`): the complete `cli.step`
spans less the `cli.sync.*` spans inside them, over the steps. Read from
the port's span store in this process (`perf_bench/spans.py`, which
imports `balance_robot_tpu_torch.utils.profiling`)."""
from perf_bench import spans


def value(store_spans, counters):
    s = spans.cli_steps(store_spans)
    return None if s is None else \
        1e-6 * (s["step_ns"] - s["wait_ns"]) / s["steps"]


def read(data):
    return spans.read(value)
