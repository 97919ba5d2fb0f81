"""Time the port's K1, K2 and K3 kernels against other builds of them, in
turns, in one process on one GPU.

    python tools/time_kernels.py [--variant K2:BRT_K2_TEAM=8 ...]
                                 [--old-csrc DIR] [--only K1 ...]
                                 [--rounds 2] [--out FILE] [--sections]

Builds K1 (`csrc/control_step.cu`), K2 (`csrc/control_step14.cu`) and K3
(`csrc/control_step_walls.cu`) as they are, once more for each --variant KERNEL:NAME=VALUE[:NAME=VALUE...] with those macros
defined (`BRT_K1_TEAM` / `BRT_K2_TEAM` / `BRT_K3_TEAM`: lanes per env
below their (first) crossover; `BRT_K2_MID_TEAM`: K2's middle team;
`BRT_K1_MINB` / `BRT_K2_MINB`: the blocks per SM that `__launch_bounds__`
asks registers for; `BRT_K2_MID`, `BRT_K2_CROSSOVER` / `BRT_K1_CROSSOVER`
/ `BRT_K3_CROSSOVER`: the batch from which K2 runs its middle team and its
team of 8, and K1 and K3 one lane per env, 0 for always, a large one for
never), and, with --old-csrc, from another checkout's `csrc/` directory
(an earlier design with the same C interface), all nvcc runs started
together;
--only names the kernels to build and time (all three by default). The
inputs are states of the kind chip_smoke.py times: the Env01-v2, Env03-v2
and EnvMove05-v1 main paths (4096 envs, 25 steps of the checked-in
policies, fast solver), run through the default build, each with the
noise of its own seeded generator (K1's draws are chip_smoke.py's).
Every kernel runs at B = 1, at 4096 and at each crossover - 1 (the last
batch of a rung: the library's `crossovers()`), besides these cases: K1
at B = 256 (Env01 serving's batch), 512, 1024 (training), 1536, 2048,
2176 and 3072, fast and exact grade (2112 is one wave of its 32-lane
team); K2 at B = 512 (the evals), 1024 (training and the flagship
serving), 1,792 (the oracle's generations) and 2048, fast and exact grade,
and at 896 on the MPC expert's lockstep batch (14 impact states x 64
candidates), fast and exact grade; K3 at B = 2048,
1088, 1024 and 512 (EnvMove05-v1 serving's batch), fast grade (1056 is one
wave of its 32-lane team), and at 512, exact grade; the
first B envs of the main path's states, float32; K2 at B = 1, 512, 1024,
1,792 and 4096, fast and exact grade, on
chip_smoke.random_states14's impact states, where a third of the envs have
the block against the robot (the 14 x 14 factorization of a coupled
Hessian), and at 4096, fast grade, on the Env03-v2 main path's states after
its first step
(fresh episodes, the block in flight); K3 at B = 4096 and 512, fast grade,
on chip_smoke.random_states_walls's states, every env at a wall; K3, fast
grade, on the float32 at-the-wall states of chip_smoke.py phase 3c
(chip_smoke.check_states: B = 257 and a ragged batch above the crossover),
where each build is also held to the plain version in float32 and in
float64, per kind of wall state (where K3 drifts in float32, and where the
plain float32 version does). Then the main paths themselves (chip_smoke.py
phase 4: 4096 envs, 25 sampled steps from fresh episodes) with each build
of their kernel, in turns, by the host clock around a synchronize; and
EnvMove05-v1 serving (chip_smoke.py phase 5c: 2 x 256 episodes of 700
steps in one batch, fast and exact grade) with the default and the old
build of K3, in turns once. In each kernel case the builds are timed in
turns (a, b, ..., b, a), --rounds times, each time the median of
chip_smoke.TIMED_LAUNCHES launches by CUDA events, and each build's
outputs are compared with the default build's. Prints one line per build
and case and writes everything as JSON to --out.

With --sections it times no other build: it reads where the default
build's launches spend their time, by the section counters of the chain
(`csrc/robot_common.cuh`, taken by the timed instantiation under a
`torch.profiler` session), on K1 at B = 256 and 4096, K2 at B = 1 and 512
on the main path's and on the impact states, and K3 at 512 and 4096, each
at the fast and the exact grade. Per case: the untimed and the timed
launch's median (in turns, untimed, timed, timed, untimed), its waves
(`Kernel.waves`), the SM clock that nvidia-smi reads while timed launches
run, the slowest env's summed cycles over a launch's time at that clock
(the sections' cover of a one-wave launch), the slowest env's over the
mean env's (imbalance), the rows per substep and the share of Newton
steps that took K2's coupled 14 x 14 factorization; per section its ms
(the timed median x its share of the summed cycles), that share, the host
build's operations per env (16 envs spread over the batch, in double) and
the cycles per operation on those envs.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import chip_smoke


# the seed of each kernel's main path's noise generator: K1's draws are
# those of chip_smoke.py's Env01-v2 main path, which it runs first
MAIN_PATH_SEEDS = {"K1": 1, "K2": 2, "K3": 3}


def main_path_inputs(brt, env_id, policy_path, gen):
    """(env, after, first): the kernel's inputs (qpos, qvel, ws, ctrl) after
    chip_smoke.py's main path and after its first step (fresh episodes).
    ctrl is what the env's step hands the physics (EnvMove05-v1: its int8
    inner policy's servo targets)."""
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
        if hasattr(env, "wheel_ctrl"):
            return qpos, qvel, ws, env.wheel_ctrl(states, act)[1]
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


def serving_seconds(brt, grade):
    """(seconds, mean return) of chip_smoke.py's EnvMove05-v1 serving at
    `grade` (fast or exact)."""
    import time
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
    env = brt.make("EnvMove05-v1", seed=chip_smoke.SERVE_MOVE_SEED)
    if grade == "fast":
        env.use_fast_solver()
    policy = mlp.from_numpy_params(checkpoint.load(chip_smoke.POLICY_MOVE),
                                   device="cuda")
    n = chip_smoke.SERVE_MOVE_DRAWS * chip_smoke.SERVE_MOVE_EPISODES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets, _ = ChunkedEvaluator(
        env, lambda net, o: net.policy_mean(o).clamp(-1.0, 1.0)
    ).evaluate_detail(policy, n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, float(rets.mean())


def by_kind(kernel, ref):
    """{quantity: [largest drift of the envs of wall kind 0..5, of all]}
    (chip_smoke.random_states_walls deals the kinds in turn)."""
    kind = torch.arange(kernel[0].shape[0], device=kernel[0].device) % 6
    res = {}
    for name, a, b in zip(("qpos", "qvel", "ws"), kernel, ref):
        d = (a.double() - b.double()).abs().max(1).values
        res[name] = [float(d[kind == k].max()) for k in range(6)] \
            + [float(d.max())]
    return res


def launch_shapes(kernel, lib, dtype):
    """{batches: (lanes per env, envs per block, shared bytes per block)}
    of a build, one entry for each rung of its ladder."""
    return {f"B>={B}": kernel.launch_config(dtype, B, lib)
            for B in [1] + kernel.crossovers(lib)}


def time_sections(mod, fn, args, extra, frame_skip=250):
    """The --sections report of one case (see above): a dict, printed by
    `print_sections`."""
    from balance_robot_tpu_torch.physics.cuda_kernel import COUNTERS, SECTIONS
    K, B = mod.KERNEL, args[0].shape[0]
    cpu_only = [torch.profiler.ProfilerActivity.CPU]

    def run():
        return fn(*args, *extra)

    K.clear_sections()
    times = {"untimed": [], "timed": []}
    for kind in ("untimed", "timed", "timed", "untimed"):
        if kind == "timed":
            with torch.profiler.profile(activities=cpu_only):
                times[kind].append(chip_smoke.time_kernel(run))
        else:
            times[kind].append(chip_smoke.time_kernel(run))
    timed_ms = float(np.median(times["timed"]))
    with torch.profiler.profile(activities=cpu_only):
        for _ in range(max(3, int(np.ceil(400.0 / timed_ms)))):
            run()
        mhz = float(chip_smoke.nvidia_smi("clocks.sm",
                                          "csv,noheader,nounits"))
        torch.cuda.synchronize()
    rows = K.section_rows()[B].double()
    launches = float(rows[0, COUNTERS.index("launches")])
    cycles = rows[:, :len(SECTIONS)]
    per_env = cycles.sum(1)
    sample = torch.linspace(0, B - 1, min(B, 16)).long().unique()
    host = []
    mod.count_ops(*(t[sample] for t in args), *extra, sections=host)
    substeps = B * launches * frame_skip
    params = extra[-1]
    res = dict(
        untimed_ms=times["untimed"], timed_ms=times["timed"], sm_mhz=mhz,
        waves=K.waves(args[0].dtype, B),
        cover=float(per_env.max()) / launches / (mhz * 1e3) / timed_ms,
        imbalance=float(per_env.max() / per_env.mean()),
        rows_per_substep=float(rows[:, COUNTERS.index("rows")].sum())
        / substeps,
        coupled_share=float(rows[:, COUNTERS.index("coupled")].sum())
        / (substeps * params.newton_iters), sections={})
    for j, name in enumerate(SECTIONS):
        share = float(cycles[:, j].sum() / cycles.sum())
        ops = float(np.mean([h[name] for h in host]))
        res["sections"][name] = dict(
            ms=timed_ms * share, share=share, host_ops_per_env=ops,
            cycles_per_op=float(cycles[sample, j].mean()) / launches / ops)
    return res


def print_sections(case, r):
    u, t = np.median(r["untimed_ms"]), np.median(r["timed_ms"])
    print(f"{case}: untimed {u:.3f} ms, timed {t:.3f} ms "
          f"({100 * (t / u - 1):+.2f}%), {r['waves']} waves, SM "
          f"{r['sm_mhz']:.0f} MHz, slowest env {r['cover']:.3f} of a "
          f"launch, imbalance {r['imbalance']:.3f}, rows per substep "
          f"{r['rows_per_substep']:.2f}, coupled "
          f"{100 * r['coupled_share']:.2f}%")
    for name, sec in r["sections"].items():
        print(f"  {name}: {sec['ms']:.3f} ms, {100 * sec['share']:.1f}%, "
              f"{sec['host_ops_per_env']:.0f} host ops per env, "
              f"{sec['cycles_per_op']:.2f} cycles per op")


def with_lib(kernel, lib, fn):
    """Call fn() with `lib` as the kernel's library."""
    saved, kernel.lib = kernel.lib, lib
    try:
        return fn()
    finally:
        kernel.lib = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="KERNEL:NAME=VALUE[:NAME=VALUE...], e.g. "
                         "K2:BRT_K2_TEAM=8:BRT_K2_MINB=4")
    ap.add_argument("--old-csrc", type=pathlib.Path,
                    help="csrc/ of an earlier design to time in turns")
    ap.add_argument("--only", action="append", choices=("K1", "K2", "K3"),
                    help="time this kernel (repeatable); all three if none")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/time_kernels.json"))
    ap.add_argument("--sections", action="store_true",
                    help="where the default build's launches spend their "
                         "time, by section of the chain (see above)")
    opts = ap.parse_args()
    if opts.sections and (opts.variant or opts.old_csrc):
        ap.error("--sections times the default build only")
    chip_smoke.check(torch.cuda.is_available(), "this script needs a GPU")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card)

    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.move import MOVE05_PARAMS
    from balance_robot_tpu_torch.physics import block_step as bs
    from balance_robot_tpu_torch.physics import cuda_block, cuda_move
    from balance_robot_tpu_torch.physics import cuda_step, kernel_build
    from balance_robot_tpu_torch.physics import robot_core as rc

    # ---- builds, all nvcc runs started together
    kernels = {"K1": (cuda_step, cuda_step.control_step_cuda),
               "K2": (cuda_block, cuda_block.control_step14_cuda),
               "K3": (cuda_move, cuda_move.control_step_walls_cuda)}
    kernels = {k: v for k, v in kernels.items()
               if not opts.only or k in opts.only}
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
        mod = kernels[k][0]
        info = {}
        path = kernel_build.build(f"{mod.LABEL}_{i}", mod.SOURCE, info, proc,
                                  csrc, defines)
        lib = mod.KERNEL.bind(path)
        libs[k, bname] = lib
        shape = {str(dt)[6:]: launch_shapes(mod.KERNEL, lib, dt)
                 for dt in (torch.float32, torch.float64)}
        ptxas = [line.strip() for line in info["ptxas"].splitlines()
                 if "Used" in line or "spill" in line or "stack" in line]
        report["builds"][f"{k} {bname}"] = {
            "defines": list(defines), "old": csrc is not None,
            "team_envs_smem": shape, "ptxas": ptxas}
        print(f"build {k} {bname}: (team, envs per block, shared bytes per "
              f"block) {shape}")
        for line in ptxas:
            print("  ptxas:", line)
    for k, (mod, _) in kernels.items():
        mod.KERNEL.lib = libs[k, "default"]

    # ---- inputs: the main paths' states, through the default builds, each
    # kernel's path with the noise of its own generator (MAIN_PATH_SEEDS),
    # so that --only changes which kernels run and not their inputs
    def gen_for(kernel):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(MAIN_PATH_SEEDS[kernel])
        return gen

    with torch.inference_mode():
        def on_card(arrays):
            """float32 CUDA tensors (qpos, qvel, zero warm start, ctrl)."""
            t = [torch.tensor(x, dtype=torch.float32, device="cuda")
                 for x in arrays]
            return [t[0], t[1], torch.zeros_like(t[1]), t[2]]

        def edges(kernel):
            """B = 1, 4096 and each crossover - 1 (the last batch of a
            rung) of `kernel`'s default build."""
            crossovers = kernels[kernel][0].KERNEL.crossovers()
            return {1, 4096} | {x - 1 for x in crossovers}

        cases, section_cases = [], []
        if "K1" in kernels:
            env01, s01, _ = main_path_inputs(brt, "Env01-v2",
                                             chip_smoke.POLICY, gen_for("K1"))
            cases += [("K1", B, grade, s01, (None, params))
                      for grade, params in (("fast", env01.params),
                                            ("exact", rc.ENV01_PARAMS))
                      for B in sorted({256, 512, 1024, 1536, 2048, 2176,
                                       3072} | edges("K1"))]
            section_cases += [("K1", B, grade, s01, (None, params))
                              for grade, params in (("fast", env01.params),
                                                    ("exact",
                                                     rc.ENV01_PARAMS))
                              for B in (256, 4096)]
        if "K2" in kernels:
            env03, s03, s03_first = main_path_inputs(
                brt, "Env03-v2", chip_smoke.POLICY03, gen_for("K2"))
            q, v, u = chip_smoke.random_states14(np.random.default_rng(5),
                                                 chip_smoke.N_ENVS)
            impact = on_card((q, v, u))
            # the MPC expert's plan rollouts: 14 states of the block against
            # the robot (random_states14's kinds 4 and 5), 64 candidates each
            rows = np.repeat(np.nonzero(np.arange(len(q)) % 6 >= 4)[0][:14],
                             64)
            lockstep = on_card((q[rows], v[rows], u[rows] + 0.5 * np.random.
                                default_rng(8).normal(size=(len(rows), 2))))
            grades = {"fast": (env03.params,), "exact": (bs.ENV03_PARAMS,)}
            cases += [("K2", B, grade, s03, grades[grade])
                      for grade in grades
                      for B in sorted({512, 1024, 2048} | edges("K2"))]
            cases += [("K2", 896, grade + " lockstep", lockstep,
                       grades[grade]) for grade in grades]
            cases += [("K2", 1792, grade, s03, grades[grade])
                      for grade in grades]
            cases += [("K2", B, grade + " impact", impact, grades[grade])
                      for grade in grades
                      for B in (1, 512, 1024, 1792, 4096)]
            cases += [("K2", 4096, "fast first-step", s03_first,
                       (env03.params,))]
            section_cases += [("K2", B, grade + kind, states, grades[grade])
                              for kind, states in (("", s03),
                                                   (" impact", impact))
                              for grade in grades for B in (1, 512)]
        if "K3" in kernels:
            env_move, smove, _ = main_path_inputs(
                brt, "EnvMove05-v1", chip_smoke.POLICY_MOVE, gen_for("K3"))
            at_wall = on_card(chip_smoke.random_states_walls(
                np.random.default_rng(5), chip_smoke.N_ENVS))
            fast = (env_move.params,)
            cases += [("K3", B, "fast", smove, fast) for B in sorted(
                {512, 1024, 1088, 2048} | edges("K3"), reverse=True)]
            cases += [("K3", 512, "exact", smove, (MOVE05_PARAMS,)),
                      ("K3", 4096, "fast at-wall", at_wall, fast),
                      ("K3", 512, "fast at-wall", at_wall, fast)]
            section_cases += [("K3", B, grade, smove, extra)
                              for grade, extra in (("fast", fast),
                                                   ("exact",
                                                    (MOVE05_PARAMS,)))
                              for B in (512, 4096)]
            # phase 3c's float32 K3 checks, held per kind to both plain
            # versions
            X3, = cuda_move.KERNEL.crossovers()
            check3 = chip_smoke.check_states(X3)["K3"]
            cases += [("K3", B, "fast phase-3c", on_card(draws[2]), fast)
                      for B, draws in check3.items()]
        for k, B, grade, states, extra in (section_cases if opts.sections
                                           else []):
            mod, fn = kernels[k]
            case = f"{k} B={B} {grade}"
            report["cases"][case] = time_sections(
                mod, fn, tuple(t[:B].contiguous() for t in states), extra)
            print_sections(case, report["cases"][case])
        for k, B, grade, states, extra in ([] if opts.sections else cases):
            mod, fn = kernels[k]
            args = tuple(t[:B].contiguous() for t in states) + extra
            names = [b for (kk, b) in libs if kk == k]
            ref = with_lib(mod.KERNEL, libs[k, "default"], lambda: fn(*args))
            times = {b: [] for b in names}
            drift, kinds = {}, {}
            if grade.endswith("phase-3c"):
                plain = {dt: cuda_move.control_step_walls_plain(
                    *(t.to(dt) for t in args[:4]), *extra)
                    for dt in (torch.float32, torch.float64)}
                kinds["plain f32 vs plain f64"] = by_kind(
                    plain[torch.float32], plain[torch.float64])
            for b in names:
                out = with_lib(mod.KERNEL, libs[k, b], lambda: fn(*args))
                drift[b] = chip_smoke.drift(out, ref)
                if kinds:
                    for dt in (torch.float32, torch.float64):
                        kinds[f"{b} vs plain {str(dt)[6:]}"] = by_kind(
                            out, plain[dt])
            for _ in range(opts.rounds):
                for b in names + names[::-1]:
                    times[b].append(chip_smoke.time_kernel(
                        lambda: with_lib(mod.KERNEL, libs[k, b],
                                         lambda: fn(*args))))
            case = f"{k} B={B} {grade}"
            report["cases"][case] = {b: {"ms": times[b], "drift": drift[b]}
                                     for b in names}
            for b in names:
                t = times[b]
                print(f"{case} {b}: median {np.median(t):.3f} ms, readings "
                      f"{min(t):.3f}-{max(t):.3f} ({len(t)}); vs default f32 "
                      + ", ".join(f"{key} {v:.2e}"
                                  for key, v in drift[b].items()))
            if kinds:
                report["cases"][case]["by kind"] = kinds
                for key, res in kinds.items():
                    print(f"{case} {key}: " + "; ".join(
                        f"{q} by kind "
                        + " ".join(f"{v:.2e}" for v in vals[:6])
                        + f", all {vals[6]:.3e}" for q, vals in res.items()))
        paths = (("K1", "Env01-v2", chip_smoke.POLICY),
                 ("K2", "Env03-v2", chip_smoke.POLICY03),
                 ("K3", "EnvMove05-v1", chip_smoke.POLICY_MOVE))
        for k, env_id, path in (x for x in paths if x[0] in kernels
                                and not opts.sections):
            mod = kernels[k][0]
            names = [b for (kk, b) in libs if kk == k]
            secs = {b: [] for b in names}
            steps = {b: [] for b in names}
            for _ in range(opts.rounds):
                for b in names + names[::-1]:
                    t, ms = with_lib(mod.KERNEL, libs[k, b],
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
        names = [b for b in ("default", "old") if ("K3", b) in libs
                 and not opts.sections]
        for grade in ("fast", "exact") if names else ():
            res = {b: [] for b in names}
            for b in names + names[::-1]:
                res[b].append(with_lib(cuda_move.KERNEL, libs["K3", b],
                                       lambda: serving_seconds(brt, grade)))
            report["cases"][f"serving EnvMove05-v1 {grade}"] = res
            for b in names:
                print(f"serving EnvMove05-v1 {grade} {b}: "
                      + ", ".join(f"{t:.2f} s (mean return {r:.2f})"
                                  for t, r in res[b]))
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(card)


if __name__ == "__main__":
    main()
