"""ms of a launch of the cell's kernel in the `smooth` section of its chain
(fk, com_vel, CRB, RNE, actuation, M's factor and solve; K2 also the
block's pose and bias): the kernel's median device time per launch in the
traced span (`readers.kernel_seconds`) x the section's share of the
kernel's SM cycles, summed over its envs and the traced span's launches.
The cycles are the port's section counters (`<k>.cycles.<section>` of
`profiling.counters()`, `k1` for the work file's `kernel` K1), which only
launches under a `torch.profiler` session count; None where the port keeps
none. The other `chain.*` readers take `section_ms` and `cycles` from
here."""
from perf_bench import spans
from perf_bench.readers import kernel_seconds

SECTIONS = ("smooth", "contacts", "hessian", "factor", "linesearch",
            "update")


def cycles(counters, work):
    """{section: the kernel's summed cycles}, or None where the counters
    hold none."""
    label = work["kernel"].lower()
    found = {s: counters.get(f"{label}.cycles.{s}") for s in SECTIONS}
    if None in found.values() or sum(found.values()) <= 0:
        return None
    return found


def section_ms(data, section):
    k = kernel_seconds(data)
    if k is None:
        return None

    def value(_, counters):
        found = cycles(counters, data["work"])
        return None if found is None else \
            1e3 * k * found[section] / sum(found.values())
    return spans.read(value)


def read(data):
    return section_ms(data, "smooth")
