"""The whole step's share of the fp32 peak: the frozen work of one env-step
(the kernel's operations and the policy's forward) x the traced run's
env-steps per second, over the peak."""
from perf_bench.readers import mfu_percent


def read(data):
    return mfu_percent(data, "env_steps_per_s",
                       ("kernel_ops_per_env", "policy_flops_per_env_step"))
