"""Seconds of the port's package import (`balance_robot_tpu_torch/
__init__.py`, through `_populate()`): the set-up span `setup.import`. Read
from the port's span store in this process (`perf_bench/spans.py`, which
imports `balance_robot_tpu_torch.utils.profiling`)."""
from perf_bench import spans


def value(store_spans, counters):
    return spans.seconds(store_spans, ("setup.import",))


def read(data):
    return spans.read(value)
