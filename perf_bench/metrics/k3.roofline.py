"""K3's share of its roofline: the frozen operations per env (work/) x the
batch over the fp32 peak, over K3's median device time in the traced span."""
from perf_bench.readers import roofline_percent as read  # noqa: F401
