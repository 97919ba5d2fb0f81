"""ms per step of the selection eval outside K2: the traced run's window
per step less K2's median device time per launch (the ChunkedEvaluator,
Env03's events, obs and reward, the policy)."""
from perf_bench.readers import host_ms_per_step as read  # noqa: F401
