"""K2's share of its roofline at the eval's batch: the frozen operations per
env (work/) x the batch over the fp32 peak, over K2's median device time."""
from perf_bench.readers import roofline_percent as read  # noqa: F401
