"""Time the Env03-v2 and EnvMove05-v1 steps of two checkouts of the port, in
turns, on one GPU.

    python time_env_steps.py --checkouts DIR_A DIR_B [--out FILE]

Runs, in turns A, B, B, A, one process per turn with the port of that
checkout (`DIR/balance_robot_tpu_torch`, its kernels built into
`DIR/build/torch_kernels/` at first use), each measuring what chip_smoke.py
measures in:

  * phase 4: the Env03-v2 and EnvMove05-v1 main paths, 4096 envs x 25
    sampled steps of the checked-in policies from fresh episodes, fast
    grade, by the host clock around a synchronize; twice each, the first
    run the cold one (it loads the kernel and makes its first launches);
  * phase 9c: SAC on Env03-v2, the privileged critic warm-started from
    models/Env03-v2_SAC, 256 envs, a 1e6-row buffer, batch 256, gamma
    0.999, 50 iterations: ms per iteration, collect and update (CUDA
    events, the iterations after the first);
  * phase 11c: the paired eval of models/Env03-v2_r2i at seed 0, 512
    episodes of 1200 steps, fast grade: seconds (host clock around a
    synchronize) and ms per step.

A turn prints one JSON line; the first process prints every turn's line
and the card's name and power limit, and writes them all to --out. A
checkout needs only its `balance_robot_tpu_torch/`: the checkpoints are
read from the `models/` beside this script. `--child DIR` runs one turn
(the first process starts these itself).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

N_ENVS, N_STEPS = 4096, 25
OFF_ITERS = 50
EVAL_EPISODES = 512
POLICIES = {"Env03-v2": "models/Env03-v2_r2i/best_model.npz",
            "EnvMove05-v1": "models/EnvMove05-v1_PPO_r4/best_model.npz"}
SAC03 = "models/Env03-v2_SAC/best_model.npz"
HERE = pathlib.Path(__file__).resolve().parent


def child(root):
    """One turn, with the port of the checkout at `root`."""
    sys.path.insert(0, str(root))
    import torch
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, factory, selection
    from balance_robot_tpu_torch.utils.profiling import Timer

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {"root": str(root)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for env_id, path in POLICIES.items():
        vec = VecEnv(brt.make(env_id).use_fast_solver(), N_ENVS)
        policy = mlp.from_numpy_params(checkpoint.load(HERE / path),
                                       device="cuda")

        def main_path():
            states, obs = vec.reset()
            for _ in range(N_STEPS):
                with torch.no_grad():
                    mean, _, _ = policy(obs)
                    states, step = vec.step(states,
                                            policy.sample(mean, gen))
                obs = step.obs
            return obs

        out[f"{env_id} main path s"] = [synced(main_path)[1]
                                        for _ in range(2)]

    tr, cfg = factory.algorithm_factory(
        "SAC", brt.make("Env03-v2").use_fast_solver(), gamma=0.999,
        privileged_critic=True)
    ts = tr.init(0, params=checkpoint.load(HERE / SAC03))
    timer = Timer()
    for i in range(OFF_ITERS):
        t = Timer() if i == 0 else timer
        with t("iteration"):
            ts, _ = tr.iteration(ts, timer=t)
    rep = timer.report()
    out["9c ms"] = {k: rep[k]["mean_ms"] for k in ("iteration", "collect",
                                                   "update")}
    del tr, ts

    env = brt.make("Env03-v2").use_fast_solver()
    params = checkpoint.load(HERE / POLICIES["Env03-v2"])
    res, seconds = synced(lambda: selection.paired_eval(
        *selection.act_fn_for(params, env), 0, EVAL_EPISODES))
    out["11c s"] = seconds
    out["11c ms per step"] = 1e3 * seconds / env.max_episode_steps
    out["11c full"] = res[0]
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkouts", nargs=2, metavar="DIR")
    ap.add_argument("--child", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.child:
        child(pathlib.Path(args.child).resolve())
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_env_steps.py needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    a, b = (pathlib.Path(d).resolve() for d in args.checkouts)
    turns = []
    for root in (a, b, b, a):
        run = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--child", str(root)], cwd=root, capture_output=True,
            text=True)
        if run.returncode:
            sys.stderr.write(run.stdout + run.stderr)
            raise SystemExit(f"the turn on {root} failed")
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": card, "turns": turns}, indent=1))


if __name__ == "__main__":
    main()
