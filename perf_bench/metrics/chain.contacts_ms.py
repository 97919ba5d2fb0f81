"""ms of a launch of the cell's kernel in the `contacts` section of its chain
(the colliders, the team's scan, the staging and the rows written, up to
the solver): as `chain.smooth_ms`, whose `section_ms` this takes."""
from perf_bench import core


def read(data):
    return core.metric_reader("chain.smooth_ms").section_ms(data, "contacts")
