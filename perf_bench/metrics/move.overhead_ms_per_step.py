"""ms per step of the move stack's data collection outside K3: the traced
run's window per step less K3's device time in it (EnvMove05's lidar
reward, the int8 inner policy and the outer obs, VecEnv.step and
auto-reset, the outer policy's forward and sample)."""
from perf_bench.readers import host_ms_per_step as read  # noqa: F401
