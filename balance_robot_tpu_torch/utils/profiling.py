"""Tracing, timing, spans and counters.

Counterpart of `balance_robot_tpu/utils/profiling.py`:
  * `trace(logdir)`: a `torch.profiler` window over the CPU and, where
    there is one, the card, written as a Chrome trace under `logdir`;
    the profiler is yielded, so `key_averages()` sums kernel time by name;
  * `Timer`: named phases, timed on the card by CUDA events recorded on
    the current stream, so timing waits for nothing until `report`
    synchronizes once (on the CPU, by the host clock).

The port's own spans and counters, kept in one in-memory store of the
process (read in-process with `spans()` and `counters()`, written out
nowhere; `clear()` empties it):
  * `span(name)`: a per-step span. It records only while a `torch.profiler`
    session records (`trace`, or any other), and then lies both in the
    profiler's trace, as a `record_function` of that name on the clock of
    the device's kernels, and in the store. Without a profiler it costs one
    check and records nothing: no setting turns spans on;
  * `setup_span(name)`: one-off set-up work (the package's import, a
    kernel's build or load, its first launch), always stored, and in the
    profiler's trace too where one records;
  * `count(name, n)`: integer counters, always on;
  * `fold(read, clear)`: counters kept elsewhere (the kernels' section
    counters on the card, `physics/cuda_kernel.py`), which `counters()`
    folds into the store as `read()` gives them and `clear()` zeroes.

A stored span is (name, parent, start_ns, end_ns), stamped by
`time.perf_counter_ns()`: `parent` is the index in `spans()` of the
enclosing stored span, or None; `end_ns` is None while the span is open,
and for a per-step span during which the profiler stopped. Spans nest as
the `with` blocks of one thread do. The store holds at most `MAX_SPANS`;
the spans past it are counted in `profiling.spans_dropped`.
"""

import contextlib
import time

import torch
from torch.autograd import _profiler_enabled

from ..device import resolve_device

MAX_SPANS = 100_000

_spans = []     # [name, parent, start_ns, end_ns] per stored span
_open = []      # each open span's index (None: not stored), innermost last
_counters = {}
_folds = []     # (read, clear) of each source of folded counters
_OFF = contextlib.nullcontext()


def recording():
    """Whether a `torch.profiler` session records: what turns per-step
    spans and the kernels' section timers on."""
    return _profiler_enabled()


class _Span:
    __slots__ = ("name", "per_step", "start_ns", "rf", "record")

    def __init__(self, name, per_step, start_ns=None):
        self.name = name
        self.per_step = per_step
        self.start_ns = start_ns

    def __enter__(self):
        self.rf = None
        if self.per_step or _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.record = None
        if len(_spans) < MAX_SPANS:
            self.record = [self.name, _open[-1] if _open else None,
                           self.start_ns or time.perf_counter_ns(), None]
            _open.append(len(_spans))
            _spans.append(self.record)
        else:
            _open.append(None)
            count("profiling.spans_dropped")
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        # a per-step span is whole only if the profiler recorded all of it
        if self.record is not None and (not self.per_step
                                        or _profiler_enabled()):
            self.record[3] = end
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name):
    """`with span(name):` around per-step work; recorded only while a
    `torch.profiler` session records."""
    return _Span(name, True) if recording() else _OFF


def setup_span(name, start_ns=None):
    """`with setup_span(name):` around one-off set-up work; always stored.
    `start_ns`: a `time.perf_counter_ns()` stamp taken where the work
    began, before this module could be imported."""
    return _Span(name, False, start_ns)


def count(name, n=1):
    _counters[name] = _counters.get(name, 0) + n


def spans():
    """The stored spans, (name, parent, start_ns, end_ns) each, in the
    order they began."""
    return [tuple(r) for r in _spans]


def fold(read, clear):
    """Fold a source of counters kept elsewhere into the store: `read()`
    ({name: n}) on each call of `counters()`, `clear()` on `clear()`."""
    _folds.append((read, clear))


def counters():
    """The counters, the folded ones read now (one read per source)."""
    out = dict(_counters)
    for read, _ in _folds:
        out.update(read())
    return out


def clear():
    """Empty the store, and zero the folded counters where they are kept; a
    span still open is then stored nowhere."""
    _spans.clear()
    _open[:] = [None] * len(_open)
    _counters.clear()
    for _, zero in _folds:
        zero()


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
