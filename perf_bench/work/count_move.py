"""Take the frozen work of the move cell (work/envmove05.rollout.json) on
the card. The benchmark never runs this; it records how the counts were
taken.

    python perf_bench/work/count_move.py [--out PATH]

It runs `count_work.count("envmove05.rollout")` (a 3 s window of the cell;
K3's own source counts the operations of 16 envs of its last launch) and,
on the same 16 envs of that launch, the plain wall physics in float64 with
its contact record: an env is at a wall where any wall contact was
included in any substep of the step. It prints, and writes to `--out`,
the work file: K3's operations per env with their spread, the share of the
counted envs at a wall, the step of the episode the launch was (all 4096
episodes start together), and the multiply-adds x 2 of the outer 10-64-64-2
policy and of the int8 inner 6-64-64-2 policy.
"""

import argparse
import json
import random
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

import torch  # noqa: E402

from perf_bench.work import count_work  # noqa: E402

CELL, SEED = "envmove05.rollout", 20261017


def mlp_flops(sizes):
    """2 x the multiply-adds of a dense net with layer sizes `sizes`."""
    return 2 * sum(a * b for a, b in zip(sizes, sizes[1:]))


def main(argv=None):
    from balance_robot_tpu_torch.physics import cuda_move
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    launch = cuda_move.control_step_walls_cuda
    seen = dict(n=0, last=None)

    def keep(*a, **k):
        seen["n"] += 1
        seen["last"] = a
        return launch(*a, **k)

    cuda_move.control_step_walls_cuda = keep
    try:
        counted = count_work.count(CELL, SEED)
    finally:
        cuda_move.control_step_walls_cuda = launch
    qpos, qvel, ws, ctrl, params = seen["last"][:5]
    picked = random.Random(SEED).sample(range(qpos.shape[0]), 16)
    contacts = {}
    cuda_move.control_step_walls_plain(
        *(t[picked].double() for t in (qpos, qvel, ws, ctrl)), params,
        contact_counts=contacts)
    at_wall = torch.stack(list(contacts.values())).any(0)
    work = dict(
        kernel="K3", kernel_name="control_step_walls_kernel",
        batch=counted["batch"], grade="fast",
        kernel_ops_per_env=counted["ops_per_env"],
        kernel_ops_min=counted["min"], kernel_ops_max=counted["max"],
        envs_at_a_wall=f"{int(at_wall.sum())} of {len(picked)}",
        episode_step=seen["n"],
        kernel_ops_counted=(
            "count_move.py on the card when the cell was defined: the "
            "kernel's own count_ops (a team of one lane on the host, in "
            "double, every +, -, *, / and math call once) on 16 envs of "
            f"the last launch of a 3 s window, seed {SEED}, "
            f"launch {seen['n']} of the run (the episodes' step), per env "
            f"min {counted['min']}, max {counted['max']}; "
            f"{int(at_wall.sum())} of the 16 at a wall (a wall contact in "
            "a substep of the plain physics)"),
        kernel_bytes_per_env=4 * (27 + 25),
        kernel_bytes_note=(
            "float32 state in (27 numbers) and out (25), each once: "
            f"{4 * (27 + 25) * counted['batch']} bytes per launch, under a "
            "microsecond at 3.35 TB/s, so the operations bound the kernel"),
        policy_flops_per_env_step=mlp_flops((10, 64, 64, 2)),
        policy_flops_note=("forward of the outer 64-64 tanh trunk, 2 x (10 "
                           "x 64 + 64 x 64 + 64 x 2)"),
        inner_policy_ops_per_env_step=mlp_flops((6, 64, 64, 2)),
        inner_policy_ops_note=(
            "the int8 inner policy's multiply-adds x 2, 2 x (6 x 64 + 64 x "
            "64 + 64 x 2), each an exact integer product in float32"))
    text = json.dumps(work, indent=2) + "\n"
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
