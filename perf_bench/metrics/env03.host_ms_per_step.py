"""ms of the host's time to issue one Env03 step: the summed length of the
complete `env03.step` spans (`Env03V1.step`, recorded under the traced
span's profiler; the park and fire events nest in it as `env03.events`)
over their count. Read from the port's span store in this process
(`perf_bench/spans.py`); None where the port records no such span."""
from perf_bench import spans


def value(store_spans, counters):
    steps = [e - b for n, _, b, e in store_spans
             if n == "env03.step" and e is not None]
    return 1e-6 * sum(steps) / len(steps) if steps else None


def read(data):
    return spans.read(value)
