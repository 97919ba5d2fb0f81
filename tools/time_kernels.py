"""Time the port's K1 and K2 kernels against other builds of them, in turns,
in one process on one GPU.

    python tools/time_kernels.py [--variant K2:BRT_K2_TEAM=8 ...]
                                 [--old-csrc DIR] [--rounds 2] [--out FILE]

Builds K1 (`csrc/control_step.cu`) and K2 (`csrc/control_step14.cu`) as
they are, once more for each --variant KERNEL:NAME=VALUE[:NAME=VALUE...]
with those macros defined (`BRT_K1_TEAM` / `BRT_K2_TEAM`: lanes per env;
`BRT_K1_MINB` / `BRT_K2_MINB`: the blocks per SM that `__launch_bounds__`
asks registers for), and, with --old-csrc, from another checkout's `csrc/`
directory (an earlier design with the same C interface), all nvcc runs
started together. The inputs are the states chip_smoke.py times: the
Env01-v2 and Env03-v2 main paths (4096 envs, 25 steps of the checked-in
policies, fast solver), run through the default build. Cases: K1 at
B = 4096 and 256 (Env01 serving's batch), fast grade; K2 at B = 4096, fast
grade, and at B = 1024, exact grade (the flagship serving's batch and
grade); the first B envs of the main path's states, float32; and K2 at
B = 4096, fast grade, on chip_smoke.random_states14's impact states, where
a third of the envs have the block against the robot (the 14 x 14
factorization of a coupled Hessian), and on the Env03-v2 main path's states
after its first step (fresh episodes, the block in flight). Last, the
Env01-v2 and Env03-v2 main paths themselves (chip_smoke.py phase 4: 4096
envs, 25 sampled steps from fresh episodes) with each build of their
kernel, in turns, by the host clock around a synchronize. In each case
the builds are timed in turns (a, b, ..., b, a), --rounds times, each time
the median of chip_smoke.TIMED_LAUNCHES launches by CUDA events, and each
build's outputs are compared with the default build's. Prints one line per
build and case and writes everything as JSON to --out.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import chip_smoke


def main_path_inputs(brt, env_id, policy_path, gen):
    """(env, after, first): the kernel's inputs (qpos, qvel, ws, ctrl) after
    chip_smoke.py's main path and after its first step (fresh episodes)."""
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint
    env = brt.make(env_id).use_fast_solver()
    policy = mlp.from_numpy_params(checkpoint.load(policy_path),
                                   device="cuda")
    vec = VecEnv(env, chip_smoke.N_ENVS)
    states, obs = vec.reset()

    def inputs():
        qpos, qvel, ws = states.phys
        act = policy.policy_mean(obs).clamp(-1.0, 1.0)
        return qpos, qvel, ws, qvel[:, 6:8] + act * 4.0

    for step in range(chip_smoke.N_STEPS):
        mean, _, _ = policy(obs)
        states, out = vec.step(states, policy.sample(mean, gen))
        obs = out.obs
        if step == 0:
            first = inputs()
    return env, inputs(), first


def main_path_seconds(brt, env_id, policy_path):
    """(seconds, ms of each step) of chip_smoke.py's main path of `env_id`:
    reset, then N_STEPS sampled steps of N_ENVS envs, the same noise every
    time; the steps by CUDA events."""
    import time
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint
    vec = VecEnv(brt.make(env_id).use_fast_solver(), chip_smoke.N_ENVS)
    policy = mlp.from_numpy_params(checkpoint.load(policy_path),
                                   device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    states, obs = vec.reset()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(chip_smoke.N_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for e in events[1:]:
        mean, _, _ = policy(obs)
        states, out = vec.step(states, policy.sample(mean, gen))
        obs = out.obs
        e.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, [a.elapsed_time(b) for a, b in
                                      zip(events, events[1:])]


def with_lib(mod, lib, fn):
    """Call fn() with `lib` as the module's kernel library."""
    saved, mod._lib = mod._lib, lib
    try:
        return fn()
    finally:
        mod._lib = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="KERNEL:NAME=VALUE[:NAME=VALUE...], e.g. "
                         "K2:BRT_K2_TEAM=8:BRT_K2_MINB=4")
    ap.add_argument("--old-csrc", type=pathlib.Path,
                    help="csrc/ of an earlier design to time in turns")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/time_kernels.json"))
    opts = ap.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "this script needs a GPU")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card)

    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.physics import block_step as bs
    from balance_robot_tpu_torch.physics import cuda_block, cuda_step
    from balance_robot_tpu_torch.physics import kernel_build

    # ---- builds, all nvcc runs started together
    kernels = {"K1": (cuda_step, "k1_launch_config"),
               "K2": (cuda_block, "k2_launch_config")}
    specs = []       # (kernel, build name, csrc, defines)
    for name in kernels:
        specs.append((name, "default", None, ()))
        for v in opts.variant:
            k, *defs = v.split(":")
            if k == name:
                specs.append((name, " ".join(defs), None,
                              tuple(f"-D{d}" for d in defs)))
        if opts.old_csrc:
            specs.append((name, "old", opts.old_csrc, ()))
    procs = [kernel_build.start_build(f"{kernels[k][0].LABEL}_{i}",
                                      kernels[k][0].SOURCE, csrc, defines)
             for i, (k, _, csrc, defines) in enumerate(specs)]
    libs, report = {}, {"card": card, "builds": {}, "cases": {}}
    for i, ((k, bname, csrc, defines), proc) in enumerate(zip(specs, procs)):
        mod, config = kernels[k]
        info = {}
        path = kernel_build.build(f"{mod.LABEL}_{i}", mod.SOURCE, info, proc,
                                  csrc, defines)
        lib = mod._bind(path)
        libs[k, bname] = lib
        shape = {}
        if hasattr(lib, config):
            for dt in (torch.float32, torch.float64):
                shape[str(dt)[6:]] = cuda_step.read_launch_config(
                    getattr(lib, config), dt)
        ptxas = [line.strip() for line in info["ptxas"].splitlines()
                 if "Used" in line or "spill" in line or "stack" in line]
        report["builds"][f"{k} {bname}"] = {
            "defines": list(defines), "old": csrc is not None,
            "team_envs_smem": shape, "ptxas": ptxas}
        print(f"build {k} {bname}: (team, envs per block, shared bytes per "
              f"block) {shape or 'one thread per env'}")
        for line in ptxas:
            print("  ptxas:", line)
    cuda_step._lib = libs["K1", "default"]
    cuda_block._lib = libs["K2", "default"]

    # ---- inputs: the main paths' states, through the default builds
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.inference_mode():
        env01, s01, _ = main_path_inputs(brt, "Env01-v2", chip_smoke.POLICY,
                                         gen)
        env03, s03, s03_first = main_path_inputs(
            brt, "Env03-v2", chip_smoke.POLICY03, gen)
        impact = [torch.tensor(x, dtype=torch.float32, device="cuda")
                  for x in chip_smoke.random_states14(
                      np.random.default_rng(5), chip_smoke.N_ENVS)]
        impact.insert(2, torch.zeros_like(impact[1]))
        cases = [
            ("K1", 4096, "fast", s01, (None, env01.params)),
            ("K1", 256, "fast", s01, (None, env01.params)),
            ("K2", 4096, "fast", s03, (env03.params,)),
            ("K2", 1024, "exact", s03, (bs.ENV03_PARAMS,)),
            ("K2", 4096, "fast impact", impact, (env03.params,)),
            ("K2", 4096, "fast first-step", s03_first, (env03.params,))]
        for k, B, grade, states, extra in cases:
            mod = kernels[k][0]
            fn = (cuda_step.control_step_cuda if k == "K1"
                  else cuda_block.control_step14_cuda)
            args = tuple(t[:B].contiguous() for t in states) + extra
            names = [b for (kk, b) in libs if kk == k]
            ref = with_lib(mod, libs[k, "default"], lambda: fn(*args))
            times = {b: [] for b in names}
            drift = {}
            for b in names:
                out = with_lib(mod, libs[k, b], lambda: fn(*args))
                drift[b] = chip_smoke.drift(out, ref)
            for _ in range(opts.rounds):
                for b in names + names[::-1]:
                    times[b].append(chip_smoke.time_kernel(
                        lambda: with_lib(mod, libs[k, b], lambda: fn(*args))))
            case = f"{k} B={B} {grade}"
            report["cases"][case] = {b: {"ms": times[b], "drift": drift[b]}
                                     for b in names}
            for b in names:
                t = times[b]
                print(f"{case} {b}: median {np.median(t):.3f} ms, readings "
                      f"{min(t):.3f}-{max(t):.3f} ({len(t)}); vs default f32 "
                      + ", ".join(f"{key} {v:.2e}"
                                  for key, v in drift[b].items()))
        for k, env_id, path in (("K1", "Env01-v2", chip_smoke.POLICY),
                                ("K2", "Env03-v2", chip_smoke.POLICY03)):
            mod = kernels[k][0]
            names = [b for (kk, b) in libs if kk == k]
            secs = {b: [] for b in names}
            steps = {b: [] for b in names}
            for _ in range(opts.rounds):
                for b in names + names[::-1]:
                    t, ms = with_lib(mod, libs[k, b],
                                     lambda: main_path_seconds(brt, env_id,
                                                               path))
                    secs[b].append(t)
                    steps[b].append(ms)
            report["cases"][f"main path {env_id}"] = {
                b: {"s": secs[b], "step_ms": steps[b]} for b in names}
            for b in names:
                t = np.median(secs[b])
                print(f"main path {env_id} {b}: median {t:.3f} s = "
                      f"{chip_smoke.N_ENVS * chip_smoke.N_STEPS / t:.1f} "
                      f"env-steps/s, readings {min(secs[b]):.3f}-"
                      f"{max(secs[b]):.3f} s ({len(secs[b])}); ms per step "
                      "(median over readings): "
                      + " ".join(f"{x:.0f}"
                                 for x in np.median(steps[b], axis=0)))
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(card)


if __name__ == "__main__":
    main()
