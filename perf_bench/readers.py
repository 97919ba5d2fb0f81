"""What the per-layer readers (metrics/<name>.py) share.

A reader gets `data`: the traced span (`tracing.read_events`), the window
of the traced run (seconds, steps, env_steps, and the step intervals of the
interactive loop), its end-to-end values, the cell's frozen work
(work/<cell>.json) and the peak (work/peak.json). A reader returns a
number, or None where it finds nothing to read; a cell that lists the
metric then fails its run (`run.MissingMetric`), so that a kernel renamed
or taken off the path cannot silence it.
"""

from . import window as win
from .tracing import kernel_busy_s, kernel_times


def kernel_seconds(data):
    """The median device time (s) of one launch of the cell's kernel in
    the traced span, or None."""
    work = data["work"]
    if not work or not data["trace"]:
        return None
    times = kernel_times(data["trace"], work["kernel_name"])
    return win.median(times) if times else None


def idle_percent(data):
    span = data["trace"]
    if not span or span["window_s"] <= 0 or span["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - span["busy_s"] / span["window_s"])


def host_ms_per_step(data):
    """The traced span's time per step less the kernel's device time per
    step in it (one launch per step; `tracing.kernel_busy_s`), in ms: the
    time of a step spent outside the kernel."""
    work, span = data["work"], data["trace"]
    steps = data["window"].get("traced_steps")
    if not work or not span or not steps:
        return None
    k = kernel_busy_s(span, work["kernel_name"])
    if not k:
        return None
    return 1e3 * (span["window_s"] - k) / steps


def roofline_percent(data):
    """The kernel's frozen operations per env x the batch, over the peak,
    over the kernel's median device time."""
    work, k = data["work"], kernel_seconds(data)
    if k is None:
        return None
    least = work["kernel_ops_per_env"] * work["batch"] \
        / data["peak"]["fp32_flops_per_s"]
    return 100.0 * least / k


def mfu_percent(data, rate_name, parts):
    """The frozen work of one env-step (the `parts` of work/<cell>.json
    summed) x the traced run's env-steps per second, over the peak."""
    work = data["work"]
    if not work or rate_name not in data["e2e"]:
        return None
    per_step = sum(work[p] for p in parts)
    return 100.0 * per_step * data["e2e"][rate_name] \
        / data["peak"]["fp32_flops_per_s"]
