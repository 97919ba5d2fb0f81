"""The control of `correct`: the reference, computed in bfloat16 (the nearest
precision below the configurations' float32), put in the program's place,
must come out as not correct.

    python perf_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

With `--fault <name>` (one of `faults.py`'s) it plants that fault in the
timed path instead and prints the program's numbers: a fault's reading on
the card. For each seed it runs the cell as `run.py` does, at the cell's
own size, with a window of `--seconds` (long enough for the sampled steps),
then holds the reference's outputs in bfloat16, from the same recorded
inputs, to the reference's in float64 with the cell's numbers and limits.
It prints one JSON line per seed: the control's (or the fault's) numbers
beside the limits, and whether it was (wrongly) found correct; the
program's own numbers of the same run go to standard error. Exit code 1 if
any seed's control passed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from perf_bench import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if args.fault:
        from perf_bench import faults
        getattr(faults, args.fault)(setattr)
    passed = False
    for seed in args.seeds:
        result = run.run(["--workload", args.workload, "--seed", str(seed),
                          "--seconds", str(args.seconds)],
                         control=not args.fault)
        passed |= result["correct"]
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              fault=args.fault, found_correct=result[
                                  "correct"], checks=result["checks"])),
              flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
