"""The slowest env's SM cycles in the cell's kernel over the mean env's,
summed over the traced span's launches: `<k>.cycles.slowest_env` over the
six sections' summed cycles per env counted (`<k>.envs`), from the port's
section counters (see `chain.smooth_ms`). 1 where every env's chain takes
as long; where one env runs per warp, the slowest env sets the launch."""
from perf_bench import core, spans


def read(data):
    work = data["work"]
    if not work:
        return None
    chain = core.metric_reader("chain.smooth_ms")
    label = work["kernel"].lower()

    def value(_, counters):
        found = chain.cycles(counters, work)
        envs = counters.get(f"{label}.envs")
        slowest = counters.get(f"{label}.cycles.slowest_env")
        if found is None or not envs or slowest is None:
            return None
        return slowest * envs / sum(found.values())
    return spans.read(value)
