"""ms of a launch of the cell's kernel in the `hessian` section of its chain
(warm start's cost pass, then per Newton step the row pass and the Hessian
and gradient): as `chain.smooth_ms`, whose `section_ms` this takes."""
from perf_bench import core


def read(data):
    return core.metric_reader("chain.smooth_ms").section_ms(data, "hessian")
