"""Run one cell of the port's benchmark, once.

    python perf_bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell's files (see `core.py`) say what runs. A run

  1. refuses to start without CUDA or with fewer cards than the cell needs,
     and prints the card, its count and nvidia-smi's clocks and power
     limit, with the peak its rooflines divide by;
  2. sets up (`setup_s`, from the start of this script to the first timed
     step: imports, the kernel's build or load, the policy or the fresh
     init, the warm-up of the cell's own shapes);
  3. measures for `--seconds`, to the first work boundary after them;
     with `--trace 1` it profiles a short steady part of the window and
     reports the per-layer metrics instead of the end-to-end ones;
  4. reads the peak of device memory, frees the program's state, and holds
     what the timed path produced to the plain reference (`check.py`);
  5. prints each number compared beside its limit on standard error, and
     as its last line on standard output one JSON object: correct,
     attempted, failed, metrics, device, [breakdown], checks.

No run may hold JAX or the JAX package: the loaded modules are checked
after set-up, after the window and before the result, by whole top-level
name. Exit codes: 0 a result, 2 refused (no card, a forbidden module, an
unknown cell), 1 a per-layer metric that the cell lists and the traced
run did not give, anything else a failure of the run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, not this folder, leads the import path
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from perf_bench import check, core, program  # noqa: E402


class MissingMetric(RuntimeError):
    """A per-layer metric that the cell lists and the traced run did not
    give: the run fails, with no result."""


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def per_layer(bench, cell_name, data):
    """{name: {value, unit}} of every per-layer metric the cell lists, read
    by its reader from the traced run's `data`. Raises MissingMetric where
    a reader is missing or finds nothing: a kernel renamed or taken off
    the path must not silence a metric the cell lists."""
    metrics = {}
    for m in core.metrics_of_cell(bench, cell_name, "per_layer"):
        reader = core.metric_reader(m["name"])
        value = reader.read(data) if reader else None
        if value is None:
            raise MissingMetric(
                f"{cell_name} lists the per-layer metric {m['name']}, and "
                + ("its reader found nothing to read in the traced run"
                   if reader else "it has no reader (metrics/<name>.py)"))
        metrics[m["name"]] = dict(value=value, unit=m["unit"])
    return metrics


def run(argv, device="cuda", overrides=None, control=False):
    """The result dict of one run (see the module's docstring). `device`
    "cpu" and `overrides` of the traffic's parameters are for the CPU
    tests: they skip the look for a card and shrink the cell. `control`
    holds the reference in bfloat16 in the program's place to the
    reference (`control.py`); no run of the benchmark sets it."""
    import torch
    args = parser().parse_args(argv)
    bench = core.benchmark()
    entry, traffic, _, config = core.cell(args.workload, bench)
    traffic = dict(traffic, **(overrides or {}))
    core.require_no_forbidden("at start")
    if device == "cuda":
        card = core.card(entry["chips"])
        print(json.dumps(dict(card=card, nvidia_smi=core.smi(),
                              peak=core.peak())), flush=True)
    else:
        card = dict(platform="cpu", kind="cpu", count=1)
    ctx = program.context(args, entry, traffic, config, device)
    ctx.control = control
    drv = core.driver(traffic["driver"])
    if ctx.trace and device == "cuda":
        from perf_bench.tracing import TracedSpan
        TracedSpan.warm_up()
    state = drv.setup(ctx)
    program.sync(device)
    setup_s = time.perf_counter() - T_START
    core.require_no_forbidden("after set-up")

    res = drv.window(ctx, state)
    peak_bytes = (torch.cuda.max_memory_allocated()
                  if device == "cuda" else 0)
    core.require_no_forbidden("after the window")

    t_check = time.perf_counter()
    numbers = drv.compare(ctx, state, res)
    if control:
        ctx.control = False
        print("program's numbers: " + json.dumps(drv.compare(ctx, state,
                                                             res)),
              file=sys.stderr)
    print(f"comparison: {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct, rows = check.verdict(numbers, traffic["limits"])

    e2e = dict(res["e2e"], setup_s=setup_s)
    metrics = {}
    if not ctx.trace:
        for m in core.metrics_of_cell(bench, entry["name"], "end_to_end"):
            if m["name"] not in e2e:
                raise KeyError(f"the {traffic['driver']} driver measures "
                               f"no {m['name']}")
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    device_info = dict(card, memory_peak_bytes=int(peak_bytes))
    result = dict(correct=correct, attempted=res["attempted"],
                  failed=res["failed"], metrics=metrics, device=device_info)
    if ctx.trace:
        span = res["trace"]
        data = dict(trace=span, window=res, e2e=e2e,
                    work=core.work_of(entry["name"]), peak=core.peak(),
                    config=config, traffic=traffic)
        metrics.update(per_layer(bench, entry["name"], data))
        device_info.update(busy_s=span["busy_s"], window_s=span["window_s"])
        result["breakdown"] = dict(device_ops=span["top_ops"],
                                   idle_gaps=span["idle_gaps"])
    result["checks"] = {name: dict(value=value, limit=limit)
                        for name, value, limit in rows}
    core.require_no_forbidden("before the result")
    return result


def main(argv=None):
    try:
        result = run(sys.argv[1:] if argv is None else argv)
    except core.Refused as err:
        print(f"perf_bench: {err}", file=sys.stderr)
        return 2
    except MissingMetric as err:
        print(f"perf_bench: {err}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
