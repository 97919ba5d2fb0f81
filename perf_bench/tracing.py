"""The traced part of a `--trace 1` run: a short steady span of the window
under `torch.profiler`, read back from its Chrome trace.

The span starts and ends on a synchronised card (the device idle at its
start, every launch of the span finished at its end), so its length on the
host clock is the window the device's work is measured against. The trace
is written to a temporary file under the run's TMPDIR, read and deleted.

Read back: every device operation (kernels, copies, fills) inside the span,
the union of their intervals (`busy_s`), the device operations that took
most time, and the idle gaps, each named by the innermost host operation
running at its middle.
"""

import bisect
import collections
import json
import os
import tempfile
from pathlib import Path

from .window import gaps, merged_length

SPAN = "perf_bench.traced_span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


class TracedSpan:
    """`start()` / `stop()` around whole steps of the window; `read()`
    afterwards. `start()` may be called once."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = None
        self.marker = None

    @staticmethod
    def warm_up():
        """Initialise the profiler (CUPTI) once, in set-up, so that the
        traced span does not pay for it."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        torch = self.torch
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.marker = torch.profiler.record_function(SPAN)
        self.marker.__enter__()

    def stop(self):
        self.torch.cuda.synchronize()
        self.marker.__exit__(None, None, None)
        self.prof.stop()

    def read(self):
        """The span's events; see `read_events`."""
        fd, path = tempfile.mkstemp(suffix=".json",
                                    dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        return read_events(events)


def read_events(events):
    """{start_s, window_s, busy_s, device_ops: [(name, start_s, dur_s)]
    that overlap the span,
    top_ops: [[name, seconds]] (10 largest by total time), idle_gaps:
    [[host op, seconds]] (10 largest by total idle time)} from Chrome-trace
    events holding one SPAN annotation."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        raise ValueError("the trace holds no traced span")
    t0 = span[0]["ts"]
    t1 = t0 + span[0]["dur"]
    dev = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    clipped = [(max(a, t0), min(b, t1)) for _, a, b in dev]
    by_name = collections.defaultdict(float)
    for name, a, b in dev:
        by_name[name] += (b - a) / 1e6
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e
                  and e.get("name") != SPAN)
    starts = [h[0] for h in host]
    idle = collections.defaultdict(float)
    for a, b in gaps(clipped, t0, t1):
        idle[host_op_at(host, starts, (a + b) / 2.0)] += (b - a) / 1e6
    return dict(
        start_s=t0 / 1e6,
        window_s=(t1 - t0) / 1e6,
        busy_s=merged_length(clipped) / 1e6,
        device_ops=[(name, a / 1e6, (b - a) / 1e6) for name, a, b in dev],
        top_ops=[[n, s] for n, s in sorted(by_name.items(),
                                           key=lambda x: -x[1])[:10]],
        idle_gaps=[[n, s] for n, s in sorted(idle.items(),
                                             key=lambda x: -x[1])[:10]])


def host_op_at(host, starts, t, look_back=500):
    """The innermost host operation running at time t: of the operations
    (sorted by start) that hold t, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for ha, hb, name in reversed(host[max(0, i - look_back):i]):
        if hb >= t:
            return name
    return "host: between traced ops"


def kernel_times(trace, pattern):
    """The durations (s) of the span's device operations whose name holds
    `pattern`."""
    return [d for name, _, d in trace["device_ops"] if pattern in name]


def kernel_busy_s(trace, pattern):
    """The seconds of the span in which a device operation whose name
    holds `pattern` ran: its intervals clipped to the span and merged, so
    that a launch across the span's edge, or one that the trace records
    twice, counts once."""
    t0 = trace["start_s"]
    t1 = t0 + trace["window_s"]
    return merged_length([(max(a, t0), min(a + d, t1))
                          for name, a, d in trace["device_ops"]
                          if pattern in name and a < t1 and a + d > t0])
