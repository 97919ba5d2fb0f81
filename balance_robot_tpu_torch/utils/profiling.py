"""Tracing and timing.

Counterpart of `balance_robot_tpu/utils/profiling.py`:
  * `trace(logdir)`: a `torch.profiler` window over the CPU and, where
    there is one, the card, written as a Chrome trace under `logdir`;
    the profiler is yielded, so `key_averages()` sums kernel time by name;
  * `Timer`: named phases, timed on the card by CUDA events recorded on
    the current stream, so timing waits for nothing until `report`
    synchronizes once (on the CPU, by the host clock);
  * `Throughput`: env-steps/s by the host clock.
"""

import contextlib
import time

import torch

from ..device import resolve_device


@contextlib.contextmanager
def trace(logdir="logs/traces"):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


class Timer:
    """Named phases: `with timer("rollout"): ...`, then `report()`.

    On a CUDA device each phase records a pair of events; on the CPU it
    reads the host clock around the phase."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._spans = {}

    @contextlib.contextmanager
    def __call__(self, name):
        spans = self._spans.setdefault(name, [])
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                spans.append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                spans.append(time.perf_counter() - t0)

    def report(self):
        """{name: {total_s, mean_ms, n}}; synchronizes the card once."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for name, spans in self._spans.items():
            secs = [s if isinstance(s, float) else s[0].elapsed_time(s[1])
                    / 1e3 for s in spans]
            out[name] = dict(total_s=sum(secs),
                             mean_ms=1e3 * sum(secs) / len(secs),
                             n=len(secs))
        return out


class Throughput:
    """env-steps/s: `tp.add(n_steps)` after each batch, `tp.rate()` for the
    rate since construction or the last `reset()`."""

    def __init__(self):
        self.reset()

    def add(self, n):
        self.steps += n

    def rate(self):
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
