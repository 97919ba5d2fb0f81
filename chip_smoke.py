"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--serve03-steps N]

Phases, in order; any failure exits non-zero before the final line:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: K1 (csrc/control_step.cu) and K2 (csrc/control_step14.cu) with
     nvcc, both compiles started together, and ptxas's registers, stack and
     spills of each;
  3. each kernel against its plain PyTorch version on the card, B = 257
     (ragged), one control step (250 substeps), the same inputs on both
     sides: K1 on robot-floor states, K2 on robot + block states on which
     every block collider must have been active;
  4. main paths at 4096 envs, 25 control steps, the checked-in PPO policies
     (forward + sample), fast solver: Env01-v2 must launch K1 and Env03-v2
     must launch K2 exactly once per step;
  5. serving, deterministic policy: 256 fresh Env01-v2 episodes of up to 200
     steps, a few Env02-v1 steps (K1's friction branch); 2 x 512 fresh
     Env03-v2 episodes at the exact solver grade over the full 1200-step
     horizon (--serve03-steps cuts the depth), a few Env03-v1 and
     Env03-v1-fail steps;
  6. times: K1 and K2 and their plain versions at B = 4096 on the main
     paths' states, against each kernel's bound.
It ends with one JSON line per the contract: {"ok": true, "device": ...}.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 4096          # main path batch (bench.py's)
N_STEPS = 25           # control steps of the main paths
CHECK_B = 257          # ragged batch of the kernel-vs-plain checks
SERVE_EPISODES = 256
SERVE_STEPS = 200
SURVIVAL_FLOOR = 0.75  # the JAX package measured 0.89 on this protocol
SERVE03_EPISODES = 512     # per draw; the two draws run as one batch of 1024
SERVE03_DRAWS = 2
SERVE03_STEPS = 1200       # the full Env03-v2 horizon
SERVE03_SEED = 1001
# pooled full-horizon survival of models/Env03-v2_r2i: the JAX package
# records 0.895 pooled with draws between 0.84 and 0.92
SURVIVAL03_BAND = (0.84, 0.92)
TIMED_LAUNCHES = 11
POLICY = "models/Env01-v2_PPO/best_model.npz"
POLICY03 = "models/Env03-v2_r2i/best_model.npz"

# A kernel vs its plain version after one control step. float64: both sides
# do the same arithmetic in another order (fused multiply-adds on the card,
# batched LAPACK-style Cholesky and array-form colliders in the plain
# version); qpos and qvel agree to ~1e-13 and the warm start (qacc, up to
# ~1e4) to ~1e-9 relative.
F64_TOL = {"qpos": 1e-9, "qvel": 1e-9, "ws_rel": 1e-9}
# float32, K1: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 1.3e-5, qvel 5.9e-3, ws 2.2e-4 relative, over the random
# states at B = 257 and the main path's states at B = 4096 (PERF.md). A
# contact row that activates on one side and not the other moves qvel by
# ~1e-3, so qvel's bound is the widest.
F32_TOL = {"qpos": 2e-4, "qvel": 6e-2, "ws_rel": 3e-3}
# float32, K2: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 6.4e-5, qvel 5.4e-2, ws 1.1e-3 relative, over the impact
# states at B = 257 and the main path's states at B = 4096 (PERF.md). The
# block weighs 64 g and flies at up to 7.5 m/s: a contact row that
# activates one substep earlier on one side moves its velocity by ~5e-2.
K2_F32_TOL = {"qpos": 6e-4, "qvel": 5e-1, "ws_rel": 1e-2}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi(query, fmt="csv,noheader"):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def random_states_np(rng, B):
    """Robot states touching the floor in every contact regime (the
    generator of tests/test_physics_parity.py), as numpy arrays qpos, qvel,
    warm start, ctrl, friction."""
    qpos = np.zeros((B, 9))
    qpos[:, :2] = rng.normal(size=(B, 2)) * 0.01
    qpos[:, 2] = -0.0205 + rng.uniform(-0.002, 0.004, B)
    q = rng.normal(size=(B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] = rng.normal(size=(B, 2))
    qvel = rng.normal(size=(B, 8)) * np.array([.1, .1, .1, 1, 1, 1, 5, 5])
    ctrl = rng.normal(size=(B, 2)) * 10
    fric = rng.uniform(0.5, 1.0, B)
    return qpos, qvel, np.zeros((B, 8)), ctrl, fric


def random_states(rng, B, dtype):
    return tuple(torch.tensor(x, dtype=dtype, device="cuda")
                 for x in random_states_np(rng, B))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def random_states14(rng, B):
    """Robot + block states in every contact regime, as numpy arrays qpos
    (B,16), qvel (B,14), ctrl (B,2). Six kinds, in turn:
      0-1 the generator of tests/test_block_parity.py (robot touching the
          floor; block on the floor, in the air, or right at the robot);
      2   block parked at (10, 10, 0) with a leftover velocity;
      3   block just spawned: 0.3 m away at z = 0.15, 7.5 m/s at the robot;
      4   block 1-2 cm off a vertical chassis edge, closing at 1 m/s (the
          edge-edge contact);
      5   block about to hit a wheel at 3-7.5 m/s.
    """
    qpos = np.zeros((B, 16))
    qpos[:, :2] = rng.normal(size=(B, 2)) * 0.01
    qpos[:, 2] = -0.0205 + rng.uniform(-0.002, 0.004, B)
    kind = np.arange(B) % 6
    upright = kind >= 2
    tilt = rng.normal(size=B) * 0.1
    q = _unit_quats(rng, B)
    q[upright] = np.stack((np.cos(tilt / 2), np.sin(tilt / 2), 0 * tilt,
                           0 * tilt), 1)[upright]
    qpos[:, 3:7] = q
    qpos[:, 7:9] = rng.normal(size=(B, 2))
    qpos[:, 12:16] = _unit_quats(rng, B)
    qvel = rng.normal(size=(B, 14)) * np.array(
        [.1, .1, .1, 1, 1, 1, 5, 5, 2, 2, 2, 3, 3, 3])
    qvel[upright, :6] *= 0.1
    trial = np.arange(B) // 6
    near = trial % 3 == 0
    low = trial % 2 == 0
    # kinds 0-1
    qpos[:, 9:11] = np.where(near[:, None],
                             qpos[:, :2] + rng.normal(size=(B, 2)) * 0.05,
                             rng.normal(size=(B, 2)) * 0.3)
    qpos[:, 11] = np.where(low, 0.01 + rng.uniform(-0.005, 0.02, B),
                           rng.uniform(0.05, 0.2, B))
    side = rng.choice([-1.0, 1.0], B)
    side2 = rng.choice([-1.0, 1.0], B)
    speed = rng.uniform(3.0, 7.5, B)
    k = kind == 2
    qpos[k, 9:12] = [10.0, 10.0, 0.0]
    qvel[k, 8:11] = rng.normal(size=(k.sum(), 3)) * 0.05
    k = kind == 3
    ang = rng.uniform(0, 2 * np.pi, B)
    qpos[k, 9] = qpos[k, 0] + 0.3 * np.sin(ang[k])
    qpos[k, 10] = qpos[k, 1] + 0.3 * np.cos(ang[k])
    qpos[k, 11] = 0.15
    aim = np.stack((qpos[:, 0], qpos[:, 1], rng.uniform(0.1, 0.175, B)), 1) \
        - qpos[:, 9:12]
    qvel[k, 8:11] = (7.5 * aim / np.linalg.norm(aim, axis=1,
                                                keepdims=True))[k]
    k = kind == 4
    gap = rng.uniform(0.012, 0.02, B)
    corner = np.stack((side * (0.05 + gap), side2 * (0.0185 + gap)), 1)
    qpos[k, 9:11] = (qpos[:, :2] + corner)[k]
    qpos[k, 11] = rng.uniform(0.03, 0.12, B)[k]
    qvel[k, 8:11] = np.stack((-side, -side2, 0 * side), 1)[k] / np.sqrt(2)
    k = kind == 5
    qpos[k, 9] = (qpos[:, 0] + side * 0.074)[k]
    qpos[k, 10] = (qpos[:, 1] + side2 * 0.06)[k]
    qpos[k, 11] = 0.012
    qvel[k, 8:11] = np.stack((0 * side, -side2 * speed, 0 * side), 1)[k]
    ctrl = rng.normal(size=(B, 2)) * 10
    return qpos, qvel, ctrl


def drift(kernel_out, plain_out):
    dq, dv, dw = ((a - b).abs().max().item()
                  for a, b in zip(kernel_out, plain_out))
    ws_scale = max(1.0, plain_out[2].abs().max().item())
    return {"qpos": dq, "qvel": dv, "ws_rel": dw / ws_scale}


def within(d, tol):
    return all(d[k] <= tol[k] for k in tol)


def time_kernel(fn):
    """Median milliseconds of TIMED_LAUNCHES launches, by CUDA events."""
    times = []
    for _ in range(TIMED_LAUNCHES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def time_plain(fn):
    """(output, milliseconds) of one call, by the host clock around a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(ops_per_env, n_envs, tensors):
    """The least time the card could take: the kernel's operations over the
    fp32 non-tensor peak, or its bytes (each input read once, each output
    written once) over the memory rate. Returns a dict for the report."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    peak = sms * 128 * 2 * clock_mhz * 1e6
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops_ms = ops_per_env * n_envs / peak * 1e3
    bytes_ms = nbytes / 3.35e12 * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "peak": f"fp32 peak {peak / 1e12:.1f} TFLOP/s ({sms} SMs at "
                    f"{clock_mhz:.0f} MHz)"}


def print_build(name, info):
    print(f"build: {name} in {info['seconds']:.1f} s "
          f"({'reused' if info['cached'] else 'compiled'})")
    for line in info["ptxas"].splitlines():
        if "spill" in line or "Used" in line or "stack frame" in line:
            print("  ptxas:", line.strip())


def run_main_path(vec, policy, gen, modules, kernel):
    """N_STEPS sampled steps of `vec`; every kernel's count is set to 0
    just before and read just after. Returns (states, obs, seconds, counts,
    mean reward)."""
    states, obs = vec.reset()
    torch.cuda.synchronize()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rewards = []
    for _ in range(N_STEPS):
        mean, _, _ = policy(obs)
        actions = policy.sample(mean, gen)
        states, out = vec.step(states, actions)
        obs = out.obs
        rewards.append(out.reward.mean())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: m.launches for name, m in modules.items()}
    check(counts[kernel] == N_STEPS,
          f"main path launched {kernel} {counts[kernel]} times, not "
          f"{N_STEPS}")
    rewards = torch.stack(rewards)
    finite = [torch.isfinite(t).all().item() for t in
              (obs, rewards, *states.phys)]
    check(all(finite), "main path produced non-finite values")
    check(obs.shape == (N_ENVS, 6), f"obs shape {tuple(obs.shape)}")
    print(f"main path {vec.env.id}: {N_ENVS} envs x {N_STEPS} steps in "
          f"{seconds:.3f} s = {N_ENVS * N_STEPS / seconds:.1f} env-steps/s "
          f"({kernel} launches {counts[kernel]}, mean reward "
          f"{rewards.mean().item():.4f})")
    return states, obs, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve03-steps", type=int, default=SERVE03_STEPS,
                    help="depth of the Env03-v2 serving episodes "
                         f"(full horizon {SERVE03_STEPS})")
    opts = ap.parse_args()

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.physics import block_step as bs
    from balance_robot_tpu_torch.physics import cuda_block, cuda_step
    from balance_robot_tpu_torch.physics import fast_solver, kernel_build
    from balance_robot_tpu_torch.physics import robot_core as rc
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator

    # ---- 2. build: one nvcc per source, started together
    modules = {"K1": cuda_step, "K2": cuda_block}
    procs = {name: kernel_build.start_build(m.LABEL, m.SOURCE)
             for name, m in modules.items()}
    for name, m in modules.items():
        m.build(procs[name])
        print_build(name, m.build_info)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_drift = {"qpos": 0.0, "qvel": 0.0, "ws_rel": 0.0}
    with torch.inference_mode():
        # ---- 3a. K1 vs its plain version, B = 257
        rng = np.random.default_rng(0)
        max_f64 = {"K1": 0.0, "K2": 0.0}
        max_f32 = {"K1": dict(zero_drift), "K2": dict(zero_drift)}

        def record(kernel, dtype, name, d, tol32):
            print(f"{kernel} vs plain {name} {str(dtype)[6:]} B={CHECK_B}: "
                  + ", ".join(f"{key} {v:.3e}" for key, v in d.items()))
            if dtype == torch.float64:
                check(within(d, F64_TOL), f"{kernel} f64 disagrees: {d}")
                max_f64[kernel] = max(max_f64[kernel], d["qpos"], d["qvel"])
            else:
                check(within(d, tol32),
                      f"{kernel} f32 drift over bound: {d}")
                max_f32[kernel] = {key: max(max_f32[kernel][key], d[key])
                                   for key in d}

        cases = [(torch.float64, "Env01 exact", rc.ENV01_PARAMS),
                 (torch.float64, "Env01 fast", fast_solver(rc.ENV01_PARAMS)),
                 (torch.float64, "Env02 exact", rc.ENV02_PARAMS),
                 (torch.float64, "Env02 fast", fast_solver(rc.ENV02_PARAMS)),
                 (torch.float32, "Env01 fast", fast_solver(rc.ENV01_PARAMS)),
                 (torch.float32, "Env02 fast", fast_solver(rc.ENV02_PARAMS))]
        for dtype, name, params in cases:
            qpos, qvel, ws, ctrl, fric = random_states(rng, CHECK_B, dtype)
            fr = fric if params.dynamic_friction else None
            k = cuda_step.control_step_cuda(qpos, qvel, ws, ctrl, fr, params)
            p = cuda_step.control_step_plain(qpos, qvel, ws, ctrl, fr, params)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in k + p),
                  f"non-finite K1/plain output ({name}, {dtype})")
            record("K1", dtype, name, drift(k, p), F32_TOL)

        # ---- 3b. K2 vs its plain version, B = 257, on states where every
        # block collider is active during the step
        cases = [(torch.float64, "Env03 exact", bs.ENV03_PARAMS),
                 (torch.float64, "Env03 fast", fast_solver(bs.ENV03_PARAMS)),
                 (torch.float32, "Env03 fast", fast_solver(bs.ENV03_PARAMS))]
        for dtype, name, params in cases:
            qpos, qvel, ctrl = (
                torch.tensor(x, dtype=dtype, device="cuda")
                for x in random_states14(rng, CHECK_B))
            ws = torch.zeros_like(qvel)
            k = cuda_block.control_step14_cuda(qpos, qvel, ws, ctrl, params)
            seen = {}
            p = cuda_block.control_step14_plain(qpos, qvel, ws, ctrl, params,
                                                contact_counts=seen)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in k + p),
                  f"non-finite K2/plain output ({name}, {dtype})")
            active = {key: int(v.sum()) for key, v in seen.items()}
            print(f"K2 check {name} {str(dtype)[6:]}: envs with an active "
                  f"contact during the step: {active}")
            check(all(n > 0 for n in active.values()),
                  f"a block collider was never active: {active}")
            record("K2", dtype, name, drift(k, p), K2_F32_TOL)

        # ---- 4. main paths
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        env = brt.make("Env01-v2").use_fast_solver()
        policy = mlp.from_numpy_params(checkpoint.load(POLICY),
                                       device="cuda")
        states, obs, counts01 = run_main_path(VecEnv(env, N_ENVS), policy,
                                              gen, modules, "K1")
        env03 = brt.make("Env03-v2").use_fast_solver()
        policy03 = mlp.from_numpy_params(checkpoint.load(POLICY03),
                                         device="cuda")
        states03, obs03, counts03 = run_main_path(
            VecEnv(env03, N_ENVS), policy03, gen, modules, "K2")
        check(counts01["K2"] == 0 and counts03["K1"] == 0,
              f"a main path launched the other scene's kernel: {counts01} "
              f"{counts03}")

        # ---- 5a. serving, Env01-v2 and Env02-v1
        def act(net, o):
            return net.policy_mean(o).clamp(-1.0, 1.0)

        serve_env = brt.make("Env01-v2", seed=123).use_fast_solver()
        t0 = time.perf_counter()
        rets, lens = ChunkedEvaluator(serve_env, act).evaluate_detail(
            policy, SERVE_EPISODES, SERVE_STEPS)
        serve_s = time.perf_counter() - t0
        check(np.isfinite(rets).all(), "serving returned non-finite returns")
        survival = float((lens >= SERVE_STEPS).mean())
        print(f"serving: {SERVE_EPISODES} Env01-v2 episodes, max "
              f"{SERVE_STEPS} steps, in {serve_s:.2f} s: survival "
              f"{survival:.4f}, mean return {rets.mean():.4f}")
        check(survival >= SURVIVAL_FLOOR,
              f"survival {survival:.3f} < {SURVIVAL_FLOOR}")

        def few_steps(env_id, net, seed):
            vec = VecEnv(brt.make(env_id, seed=seed).use_fast_solver(),
                         SERVE_EPISODES)
            s, o = vec.reset()
            for _ in range(3):
                s, out = vec.step(s, act(net, o))
                o = out.obs
            check(torch.isfinite(o).all().item()
                  and all(torch.isfinite(t).all().item() for t in s.phys),
                  f"{env_id} state or obs not finite")
            print(f"serving: {env_id} 3 steps ok")

        few_steps("Env02-v1", policy, 7)

        # ---- 5b. serving, the flagship: Env03-v2 at the exact solver grade
        steps03 = opts.serve03_steps
        full = steps03 >= SERVE03_STEPS
        n03 = SERVE03_DRAWS * SERVE03_EPISODES
        before = cuda_block.launches
        ev = ChunkedEvaluator(brt.make("Env03-v2", seed=SERVE03_SEED), act)
        t0 = time.perf_counter()
        rets03, lens03 = ev.evaluate_detail(policy03, n03, steps03)
        serve03_s = time.perf_counter() - t0
        check(np.isfinite(rets03).all(),
              "Env03-v2 serving: non-finite return")
        alive = lens03 >= steps03
        draws = [float(a.mean()) for a in np.split(alive, SERVE03_DRAWS)]
        pooled = float(alive.mean())
        print(f"serving: {SERVE03_DRAWS} x {SERVE03_EPISODES} Env03-v2 "
              f"episodes (models/Env03-v2_r2i, exact solver, one batch of "
              f"{n03}), {'full horizon' if full else 'depth cut to'} "
              f"{steps03} steps, in {serve03_s:.1f} s with "
              f"{cuda_block.launches - before} K2 launches: survival pooled "
              f"{pooled:.4f}, draws {draws}, mean return "
              f"{rets03.mean():.2f}, mean length {lens03.mean():.1f}")
        if full:
            check(SURVIVAL03_BAND[0] <= pooled <= SURVIVAL03_BAND[1],
                  f"Env03-v2 full-horizon survival {pooled:.4f} outside the "
                  f"JAX package's band {SURVIVAL03_BAND}")
        else:
            # episodes only end early by falling, so survival to a cut depth
            # is at least the full-horizon survival
            check(pooled >= SURVIVAL03_BAND[0],
                  f"Env03-v2 survival to {steps03} steps {pooled:.4f} is "
                  f"below the full-horizon band {SURVIVAL03_BAND}")
        few_steps("Env03-v1", policy03, 8)
        few_steps("Env03-v1-fail", policy03, 9)

        # ---- 6. times at B = 4096, the main paths' inputs
        sample = torch.linspace(0, N_ENVS - 1, 16).long()
        report = []

        params = env.params
        qpos, qvel, ws = states.phys
        ctrl = qvel[:, 6:8] + act(policy, obs) * 4.0
        args = (qpos, qvel, ws, ctrl, None, params)
        k_out = cuda_step.control_step_cuda(*args)
        k_ms = time_kernel(lambda: cuda_step.control_step_cuda(*args))
        p_out, plain_ms = time_plain(
            lambda: cuda_step.control_step_plain(*args))
        d = drift(k_out, p_out)
        print(f"K1 vs plain main-path states f32 B={N_ENVS}: "
              + ", ".join(f"{key} {v:.3e}" for key, v in d.items()))
        check(within(d, F32_TOL), f"K1 f32 drift over bound at B=4096: {d}")
        max_f32["K1"] = {key: max(max_f32["K1"][key], d[key]) for key in d}
        ops = cuda_step.count_ops(*(a[sample].cpu() for a in args[:4]), None,
                                  params)[0]
        report.append(("K1", k_ms, plain_ms, float(np.mean(ops)),
                       bound(float(np.mean(ops)), N_ENVS,
                             args[:4] + k_out)))

        params = env03.params
        qpos, qvel, ws = states03.phys
        ctrl = qvel[:, 6:8] + act(policy03, obs03) * 4.0
        args = (qpos, qvel, ws, ctrl, params)
        k_out = cuda_block.control_step14_cuda(*args)
        k_ms = time_kernel(lambda: cuda_block.control_step14_cuda(*args))
        seen = {}
        p_out, plain_ms = time_plain(
            lambda: cuda_block.control_step14_plain(*args,
                                                    contact_counts=seen))
        d = drift(k_out, p_out)
        print(f"K2 vs plain main-path states f32 B={N_ENVS}: "
              + ", ".join(f"{key} {v:.3e}" for key, v in d.items())
              + "; envs with an active contact: "
              + str({key: int(v.sum()) for key, v in seen.items()}))
        check(within(d, K2_F32_TOL),
              f"K2 f32 drift over bound at B=4096: {d}")
        max_f32["K2"] = {key: max(max_f32["K2"][key], d[key]) for key in d}
        ops = cuda_block.count_ops(*(a[sample].cpu() for a in args[:4]),
                                   params)[0]
        report.append(("K2", k_ms, plain_ms, float(np.mean(ops)),
                       bound(float(np.mean(ops)), N_ENVS,
                             args[:4] + k_out)))

        for name, k_ms, plain_ms, ops, b in report:
            print(f"{name} B={N_ENVS} f32 fast: median {k_ms:.3f} ms over "
                  f"{TIMED_LAUNCHES} launches; plain {plain_ms:.1f} ms; "
                  f"{ops:.0f} ops/env/control step; {b['peak']} -> bound "
                  f"{b['ops_ms']:.4f} ms by operations, {b['bytes_ms']:.6f} "
                  f"ms by bytes ({100 * b['bound_ms'] / k_ms:.2f}% of the "
                  f"bound reached)")

    static = {
        "K1": ("k1_control_step",
               "balance_robot_tpu_torch/csrc/control_step.cu",
               "balance_robot_tpu/physics/pallas_step.py:147::_kernel",
               counts01["K1"]),
        "K2": ("k2_control_step14",
               "balance_robot_tpu_torch/csrc/control_step14.cu",
               "balance_robot_tpu/physics/pallas_block.py:567::_kernel14",
               counts03["K2"])}
    kernels = []
    for name, k_ms, plain_ms, ops, b in report:
        label, source, replaces, launches = static[name]
        err32 = max(max_f32[name]["qpos"], max_f32[name]["qvel"])
        kernels.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err32, "max_abs_f64": max_f64[name],
            "max_abs_f32": err32, "ms": k_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
