"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: K1 (csrc/control_step.cu) with nvcc, and ptxas's register and
     spill counts;
  3. K1 against its plain PyTorch version on the card, B = 257 (ragged),
     one control step (250 substeps), the same inputs on both sides;
  4. main path: Env01-v2 (fast solver), VecEnv of 4096 envs, the
     checked-in PPO policy (forward + sample), 25 control steps; K1 must
     be launched once per step;
  5. serving: deterministic evaluation of that policy over 256 fresh
     Env01-v2 episodes of up to 200 control steps, plus a few Env02-v1
     steps (K1's friction branch);
  6. times: K1 and its plain version at B = 4096, against K1's bound.
It ends with one JSON line per the contract: {"ok": true, "device": ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 4096          # main path batch (bench.py's)
N_STEPS = 25           # control steps of the main path
CHECK_B = 257          # ragged batch of the kernel-vs-plain check
SERVE_EPISODES = 256
SERVE_STEPS = 200
SURVIVAL_FLOOR = 0.75  # the JAX package measured 0.89 on this protocol
TIMED_LAUNCHES = 11
POLICY = "models/Env01-v2_PPO/best_model.npz"

# K1 vs its plain version after one control step. float64: both sides do
# the same arithmetic in another order (fused multiply-adds on the card,
# batched LAPACK-style Cholesky in the plain version); qpos and qvel agree
# to ~1e-13 and the warm start (qacc, up to ~1e4) to ~1e-9 relative.
F64_TOL = {"qpos": 1e-9, "qvel": 1e-9, "ws_rel": 1e-9}
# float32: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 1.3e-5, qvel 5.9e-3, ws 2.2e-4 relative, over the random
# states at B = 257 and the main path's states at B = 4096 (PERF.md). A
# contact row that activates on one side and not the other moves qvel by
# ~1e-3, so qvel's bound is the widest.
F32_TOL = {"qpos": 2e-4, "qvel": 6e-2, "ws_rel": 3e-3}


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


def random_states(rng, B, dtype):
    """Robot states touching the floor in every contact regime (the
    generator of tests/test_physics_parity.py), as CUDA tensors."""
    qpos = np.zeros((B, 9))
    qpos[:, :2] = rng.normal(size=(B, 2)) * 0.01
    qpos[:, 2] = -0.0205 + rng.uniform(-0.002, 0.004, B)
    q = rng.normal(size=(B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] = rng.normal(size=(B, 2))
    qvel = rng.normal(size=(B, 8)) * np.array([.1, .1, .1, 1, 1, 1, 5, 5])
    ctrl = rng.normal(size=(B, 2)) * 10
    fric = rng.uniform(0.5, 1.0, B)
    return tuple(torch.tensor(x, dtype=dtype, device="cuda")
                 for x in (qpos, qvel, np.zeros((B, 8)), ctrl, fric))


def drift(kernel_out, plain_out):
    dq, dv, dw = ((a - b).abs().max().item()
                  for a, b in zip(kernel_out, plain_out))
    ws_scale = max(1.0, plain_out[2].abs().max().item())
    return {"qpos": dq, "qvel": dv, "ws_rel": dw / ws_scale}


def within(d, tol):
    return all(d[k] <= tol[k] for k in tol)


def main():
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
    from balance_robot_tpu_torch.physics import cuda_step, fast_solver
    from balance_robot_tpu_torch.physics import robot_core as rc
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator

    # ---- 2. build
    cuda_step.build()
    info = cuda_step.build_info
    print(f"build: K1 in {info['seconds']:.1f} s "
          f"({'reused' if info['cached'] else 'compiled'})")
    for line in info["ptxas"].splitlines():
        if "spill" in line or "Used" in line or "stack frame" in line:
            print("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        # ---- 3. K1 vs its plain version, B = 257
        rng = np.random.default_rng(0)
        max_f64, max_f32 = 0.0, {"qpos": 0.0, "qvel": 0.0, "ws_rel": 0.0}
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
            d = drift(k, p)
            print(f"K1 vs plain {name} {str(dtype)[6:]} B={CHECK_B}: "
                  + ", ".join(f"{key} {v:.3e}" for key, v in d.items()))
            if dtype == torch.float64:
                check(within(d, F64_TOL), f"K1 f64 disagrees: {d}")
                max_f64 = max(max_f64, d["qpos"], d["qvel"])
            else:
                check(within(d, F32_TOL), f"K1 f32 drift over bound: {d}")
                max_f32 = {key: max(max_f32[key], d[key]) for key in d}

        # ---- 4. main path
        env = brt.make("Env01-v2").use_fast_solver()
        vec = VecEnv(env, N_ENVS)
        policy = mlp.from_numpy_params(checkpoint.load(POLICY),
                                       device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        states, obs = vec.reset()
        torch.cuda.synchronize()
        cuda_step.launches = 0
        t0 = time.perf_counter()
        rewards = []
        for _ in range(N_STEPS):
            mean, _, _ = policy(obs)
            actions = policy.sample(mean, gen)
            states, out = vec.step(states, actions)
            obs = out.obs
            rewards.append(out.reward.mean())
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        main_launches = cuda_step.launches
        check(main_launches == N_STEPS,
              f"main path launched K1 {main_launches} times, not {N_STEPS}")
        finite = [torch.isfinite(t).all().item() for t in
                  (obs, torch.stack(rewards), *states.phys)]
        check(all(finite), "main path produced non-finite values")
        check(obs.shape == (N_ENVS, 6), f"obs shape {tuple(obs.shape)}")
        print(f"main path: {N_ENVS} envs x {N_STEPS} steps in {main_s:.3f} s"
              f" = {N_ENVS * N_STEPS / main_s:.1f} env-steps/s "
              f"(K1 launches {main_launches}, mean reward "
              f"{torch.stack(rewards).mean().item():.4f})")

        # ---- 5. serving
        serve_env = brt.make("Env01-v2", seed=123).use_fast_solver()
        ev = ChunkedEvaluator(
            serve_env, lambda net, o: net.policy_mean(o).clamp(-1.0, 1.0))
        t0 = time.perf_counter()
        rets, lens = ev.evaluate_detail(policy, SERVE_EPISODES, SERVE_STEPS)
        serve_s = time.perf_counter() - t0
        check(np.isfinite(rets).all(), "serving returned non-finite returns")
        survival = float((lens >= SERVE_STEPS).mean())
        print(f"serving: {SERVE_EPISODES} Env01-v2 episodes, max "
              f"{SERVE_STEPS} steps, in {serve_s:.2f} s: survival "
              f"{survival:.4f}, mean return {rets.mean():.4f}")
        check(survival >= SURVIVAL_FLOOR,
              f"survival {survival:.3f} < {SURVIVAL_FLOOR}")
        env02 = brt.make("Env02-v1", seed=7).use_fast_solver()
        vec02 = VecEnv(env02, SERVE_EPISODES)
        s02, o02 = vec02.reset()
        for _ in range(3):
            s02, out02 = vec02.step(
                s02, policy.policy_mean(o02).clamp(-1.0, 1.0))
            o02 = out02.obs
        check(torch.isfinite(o02).all().item(), "Env02-v1 obs not finite")
        print("serving: Env02-v1 3 steps ok")

        # ---- 6. times at B = 4096, the main path's inputs
        params = env.params
        qpos, qvel, ws = states.phys
        ctrl = qvel[:, 6:8] + policy.policy_mean(obs).clamp(-1, 1) * 4.0
        args = (qpos, qvel, ws, ctrl, None, params)
        k_out = cuda_step.control_step_cuda(*args)
        times = []
        for _ in range(TIMED_LAUNCHES):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            cuda_step.control_step_cuda(*args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        k_ms = float(np.median(times))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = cuda_step.control_step_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        d = drift(k_out, p_out)
        print(f"K1 vs plain main-path states f32 B={N_ENVS}: "
              + ", ".join(f"{key} {v:.3e}" for key, v in d.items()))
        check(within(d, F32_TOL), f"K1 f32 drift over bound at B=4096: {d}")
        max_f32 = {key: max(max_f32[key], d[key]) for key in d}

        # bound: the operations K1's source does for these inputs (counted
        # on the host over a sample of envs) over the fp32 non-tensor peak
        sample = torch.linspace(0, N_ENVS - 1, 16).long()
        ops = cuda_step.count_ops(*(a[sample].cpu() for a in args[:4]),
                                  None, params)
        total_ops = float(np.mean(ops)) * N_ENVS
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
        peak = sms * 128 * 2 * clock_mhz * 1e6
        nbytes = sum(t.numel() * t.element_size() for t in args[:4]) \
            + sum(t.numel() * t.element_size() for t in k_out)
        ops_ms = total_ops / peak * 1e3
        bytes_ms = nbytes / 3.35e12 * 1e3
        print(f"K1 B={N_ENVS} f32 fast: median {k_ms:.3f} ms over "
              f"{TIMED_LAUNCHES} launches; plain {plain_ms:.1f} ms; "
              f"{np.mean(ops):.0f} ops/env/control step; fp32 peak "
              f"{peak / 1e12:.1f} TFLOP/s ({sms} SMs at {clock_mhz:.0f} MHz)"
              f" -> bound {ops_ms:.4f} ms ({100 * ops_ms / k_ms:.2f}% of "
              f"peak)")

    print(json.dumps({"kernels": [{
        "name": "k1_control_step",
        "route": "cuda",
        "source": "balance_robot_tpu_torch/csrc/control_step.cu",
        "replaces": "balance_robot_tpu/physics/pallas_step.py:147::_kernel",
        "launches": main_launches,
        "max_abs_err": max(max_f32["qpos"], max_f32["qvel"]),
        "max_abs_f64": max_f64,
        "max_abs_f32": max(max_f32["qpos"], max_f32["qvel"]),
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
