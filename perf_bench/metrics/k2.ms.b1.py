"""K2's median device time per launch at B = 1 (ms), in the traced span."""
from perf_bench.readers import kernel_seconds


def read(data):
    k = kernel_seconds(data)
    return None if k is None else 1e3 * k
