"""Break down PPO iteration time against pure rollout throughput.

Counterpart of `tools/profile_train.py`, with its options, defaults, phases
and output lines. PPO at `--envs` x `--steps`, minibatch `--mb`, on
`--env-id` at its registered solver grade. Each phase runs once to warm
up, then `--reps` times, and prints its best time:

  rollout-only     `PPO._rollout` and the mean reward (the bench path);
  gae+update-only  `PPO._gae` and `PPO._update` on one fixed trajectory;
  full iteration   `PPO.iteration` (rollout, GAE and the 10-epoch update);

then the overhead, iteration - rollout - update. On the card each call is
timed by a pair of CUDA events around it and a synchronize; on the CPU by
the host clock.

`--trace DIR` writes a `torch.profiler` trace of one full iteration
(`utils/profiling.trace`), with its phases marked "iteration", "rollout"
(GAE included) and "update". The trace is then read back, and one line per
phase gives its CUDA kernels (launched from inside the phase), their time
summed with overlaps merged, and the phase's window on the wall clock
(from the phase's start on the host to its end or its last kernel's end,
whichever is later): the share of the window in which the card ran a
kernel of the phase.

`--device cuda|cpu` is the port's own option (the JAX tool runs on JAX's
default backend): left at its default it is the card, and it raises where
there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.profile_train \\
          [--envs 1024] [--steps 64] [--mb 4096] [--trace logs/traces]
"""

import argparse
import collections
import json
import pathlib
import time

import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..utils.profiling import trace
from .ppo import PPO, PPOConfig

PHASES = ("iteration", "rollout", "update")


def build_parser():
    """Every option and default of `tools/profile_train.py`, and
    `--device`."""
    p = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.profile_train",
        description="Break down PPO iteration time vs pure rollout "
                    "throughput.")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--mb", type=int, default=4096)
    p.add_argument("--env-id", default="Env01-v2")
    p.add_argument("--trace", default=None)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the envs and the nets run (default: the "
                        "GPU; raises without one)")
    return p


def seconds_of(device, fn, *args):
    """(fn(*args), seconds): CUDA events around the call and a synchronize
    on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1e3


def _merged(intervals):
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def read_trace(path):
    """Per phase of a trace written by `run` (a Chrome trace JSON):
    {phase: dict(kernels=count, busy_ms=kernel time with overlaps merged,
    wall_ms=the phase's window, top=[(kernel name, ms, launches)] by
    time)}. A kernel belongs to the phases whose host span holds the
    runtime call that launched it."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in PHASES}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {}
    for name, (t0, t1) in spans.items():
        mine = [k for k in kernels
                if t0 <= launched.get(k["args"].get("correlation"),
                                      float("-inf")) <= t1]
        end = max([t1] + [k["ts"] + k["dur"] for k in mine])
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for k in mine:
            by_name[k["name"]][0] += k["dur"] / 1e3
            by_name[k["name"]][1] += 1
        out[name] = dict(
            kernels=len(mine),
            busy_ms=_merged([(k["ts"], k["ts"] + k["dur"])
                             for k in mine]) / 1e3,
            wall_ms=(end - t0) / 1e3,
            top=sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                       key=lambda x: -x[1]))
    return out


def run(args):
    """Profile for parsed `args`. Returns {"rollout", "update",
    "iteration": best seconds; "trace": `read_trace`'s dict or None}."""
    device = resolve_device(args.device)
    env = brt.make(args.env_id, device=device)
    cfg = PPOConfig(n_envs=args.envs, n_steps=args.steps,
                    minibatch_size=args.mb)
    ppo = PPO(env, cfg)
    ts = ppo.init(0)
    spi = cfg.n_envs * cfg.n_steps

    def rollout_only(ts):
        ts, traj = ppo._rollout(ts)
        return ts, traj["reward"].mean()

    def gae_update_only(ts, traj):
        adv, ret = ppo._gae(ts, traj)
        return ppo._update(ts, traj, adv, ret)

    def timeit(name, fn, *a, steps=None):
        out, _ = seconds_of(device, fn, *a)          # warm
        best = float("inf")
        for _ in range(args.reps):
            out, secs = seconds_of(device, fn, *a)
            best = min(best, secs)
        rate = f"  {steps / best:,.0f} env-steps/s" if steps else ""
        print(f"{name:18s} {best * 1e3:9.2f} ms{rate}")
        return out, best

    print(f"config: {args.envs} envs x {args.steps} steps, mb={args.mb}, "
          f"backend={device.type}")
    _, t_roll = timeit("rollout-only", rollout_only, ts, steps=spi)
    ts2, traj = ppo._rollout(ts)
    _, t_upd = timeit("gae+update-only", gae_update_only, ts2, traj)
    _, t_iter = timeit("full iteration", ppo.iteration, ts, steps=spi)
    print(f"{'overhead (iter - roll - upd)':30s} "
          f"{(t_iter - t_roll - t_upd) * 1e3:.2f} ms")

    phases = None
    if args.trace:
        logdir = pathlib.Path(args.trace)
        before = set(logdir.glob("*.pt.trace.json"))
        with trace(logdir):
            with torch.profiler.record_function("iteration"):
                ppo.iteration(ts, timer=torch.profiler.record_function)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        print(f"trace written to {args.trace}")
        written, = set(logdir.glob("*.pt.trace.json")) - before
        phases = read_trace(written)
        for name in PHASES:
            p = phases[name]
            share = (f"{100 * p['busy_ms'] / p['wall_ms']:.1f}%"
                     if p["wall_ms"] > 0 else "n/a")
            print(f"trace {name:9s} {p['kernels']:7d} CUDA kernels, "
                  f"{p['busy_ms']:9.2f} ms of kernel time (overlaps "
                  f"merged) in a {p['wall_ms']:9.2f} ms window: busy "
                  f"{share}")
    return dict(rollout=t_roll, update=t_upd, iteration=t_iter,
                trace=phases)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and profile."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
