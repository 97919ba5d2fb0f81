"""The share of the traced span in which no operation ran on the device
(device intervals merged), in %."""
from perf_bench.readers import idle_percent as read  # noqa: F401
