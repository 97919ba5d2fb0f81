"""The whole move step's share of the fp32 peak: the frozen work of one
env-step (K3's operations, the outer policy's forward and the int8 inner
policy's operations) x the traced run's env-steps per second, over the
peak."""
from perf_bench.readers import mfu_percent


def read(data):
    return mfu_percent(data, "env_steps_per_s",
                       ("kernel_ops_per_env", "policy_flops_per_env_step",
                        "inner_policy_ops_per_env_step"))
