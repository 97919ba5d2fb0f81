"""ms per step of data collection outside K1: the traced run's window per
step less K1's median device time per launch (VecEnv.step and auto-reset,
Env01's obs and reward, the policy's forward and sample)."""
from perf_bench.readers import host_ms_per_step as read  # noqa: F401
