"""The share (%) of K2's Newton steps that took the coupled 14 x 14
factorization (a contact row between the block and the robot), over the
traced span's timed launches: 100 x `k2.coupled_steps` / (`k2.envs` x
`k2.timed_launches` x 250 substeps x the grade's Newton iterations), the
quotient of `tools/time_kernels.py`'s `coupled_share`, from the port's
section counters (see `chain.smooth_ms`); None where the port keeps none."""
from perf_bench import core, spans

FRAME_SKIP = 250


def value(counters, newton_iters):
    coupled = counters.get("k2.coupled_steps")
    envs = counters.get("k2.envs")
    launches = counters.get("k2.timed_launches")
    if coupled is None or not envs or not launches:
        return None
    return 100.0 * coupled / (envs * launches * FRAME_SKIP * newton_iters)


def read(data):
    grade = core.solver(core.grade_name(data["traffic"], data["config"]))
    if "newton_iters" not in grade:
        return None
    return spans.read(lambda _, counters: value(counters,
                                                grade["newton_iters"]))
