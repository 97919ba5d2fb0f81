"""Seconds of the kernels' set-up: the set-up spans `kernel.load` (the
build by nvcc or the reuse of a built library, its ctypes load and bind)
and `kernel.first_launch` (the host call of the process's first launch of
each kernel entry, which holds CUDA's lazy load of the kernel), summed.
Read from the port's span store in this process (`perf_bench/spans.py`,
which imports `balance_robot_tpu_torch.utils.profiling`)."""
from perf_bench import spans


def value(store_spans, counters):
    return spans.seconds(store_spans, ("kernel.load", "kernel.first_launch"))


def read(data):
    return spans.read(value)
