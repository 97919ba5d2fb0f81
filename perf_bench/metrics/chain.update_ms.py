"""ms of a launch of the cell's kernel in the `update` section of its chain
(the constraint forces, the implicitfast update and the integration): as
`chain.smooth_ms`, whose `section_ms` this takes."""
from perf_bench import core


def read(data):
    return core.metric_reader("chain.smooth_ms").section_ms(data, "update")
