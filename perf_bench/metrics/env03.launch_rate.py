"""Block launches per env-step of the traced span: the port's tally of the
fires of Env03's events (`env03.block_launches`) over the env-steps it
counted (`env03.env_steps`), kept on the card while a profiler records and
folded into `profiling.counters()`; None where the port keeps no tally."""
from perf_bench import spans


def value(store_spans, counters):
    launches = counters.get("env03.block_launches")
    steps = counters.get("env03.env_steps")
    if launches is None or not steps:
        return None
    return launches / steps


def read(data):
    return spans.read(value)
