"""ms of the host's time to issue one EnvMove05 step: the summed length of
the complete `move.step` spans (`EnvMove05.step`, recorded under the traced
span's profiler) over their count. Read from the port's span store in this
process (`perf_bench/spans.py`, which imports
`balance_robot_tpu_torch.utils.profiling`); None where the port records no
such span."""
from perf_bench import spans


def value(store_spans, counters):
    steps = [e - b for n, _, b, e in store_spans
             if n == "move.step" and e is not None]
    return 1e-6 * sum(steps) / len(steps) if steps else None


def read(data):
    return spans.read(value)
