"""ms of a launch of the cell's kernel in the `factor` section of its chain
(per Newton step the factorization and solve of H, Ms, dMd, dMda): as
`chain.smooth_ms`, whose `section_ms` this takes."""
from perf_bench import core


def read(data):
    return core.metric_reader("chain.smooth_ms").section_ms(data, "factor")
