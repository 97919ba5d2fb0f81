"""Take the frozen work counts of work/<cell>.json, on the card. The
benchmark never runs this; it records how the counts were taken.

    python perf_bench/work/count_work.py <cell> [<cell> ...]

For each cell it runs the cell once (`run.run`, a 3 s window) with the
kernel's launch wrapped to keep the inputs of its last 16 launches, then
runs the kernel's own source on the host (`count_ops`, the port's
counting build: a team of one lane, every +, -, *, / and math call
counted once, in double) on 16 envs of the cell's own states: at B = 1
one env of each of the last 16 launches, otherwise 16 envs of the last
launch drawn from a fixed seed. It prints the mean operations per env and
control step, with the spread.

The counts are frozen on purpose: every later roofline and `mfu` divides
this same work by that later run's time, so a kernel that gets faster
reads higher, and one that gets faster by doing less than the algorithm
needs on these states cannot hide it. A count taken at run time from the
kernel's own code would move with the code it measures.
"""

import importlib
import json
import random
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

import torch  # noqa: E402

from perf_bench import core, run  # noqa: E402


def count(cell, seed=20261017):
    _, _, _, config = core.cell(cell)
    # the config names the kernel's launch and how many of its leading
    # arguments (the state, the ctrl, the scene's constants) the kernel's
    # own count_ops takes, in the launch's order
    module = importlib.import_module(config["kernel_module"])
    name = config["kernel_launch"]
    launch = getattr(module, name)
    kept = []

    def keep(*args, **kwargs):
        kept.append((args, kwargs))
        del kept[:-16]
        return launch(*args, **kwargs)

    setattr(module, name, keep)
    try:
        run.run(["--workload", cell, "--seed", str(seed), "--seconds", "3"])
    finally:
        setattr(module, name, launch)
    rows = []
    if kept[-1][0][0].shape[0] == 1:
        rows = [(args, 0) for args, _ in kept]
    else:
        args = kept[-1][0]
        picked = random.Random(seed).sample(range(args[0].shape[0]), 16)
        rows = [(args, i) for i in picked]
    counts = []
    for args, i in rows:
        one = [a[i:i + 1].cpu().double() if torch.is_tensor(a) else a
               for a in args]
        c, *_ = module.count_ops(*one[:config["kernel_state_args"]])
        counts += c
    return dict(cell=cell, kernel=config["kernel"],
                batch=int(kept[-1][0][0].shape[0]),
                ops_per_env=sum(counts) / len(counts), min=min(counts),
                max=max(counts), envs=len(counts))


if __name__ == "__main__":
    for c in sys.argv[1:]:
        print(json.dumps(count(c)), flush=True)
