"""The share (%) of the env-steps the evaluator stepped that belonged to a
live episode (`ChunkedEvaluator.evaluate_detail` steps a done episode on,
frozen, until every episode is done at a chunk's end or the horizon): the
counters `eval.live_env_steps` over `eval.stepped_env_steps`, over all the
run's evals. Read from the port's store in this process
(`perf_bench/spans.py`, which imports
`balance_robot_tpu_torch.utils.profiling`)."""
from perf_bench import spans


def value(store_spans, counters):
    stepped = counters.get("eval.stepped_env_steps")
    if not stepped or "eval.live_env_steps" not in counters:
        return None
    return 100.0 * counters["eval.live_env_steps"] / stepped


def read(data):
    return spans.read(value)
