"""The kernels' obs drift on the card over a short rollout.

Counterpart of `balance_robot_tpu/utils/drift.py`, which holds the Pallas
kernels on the TPU to the XLA path. Here the measured side is the env as
it serves on the card: K1 (Env01-v2) or K2 (Env03-v2), float32, the fast
solver grade. The reference is the same env on the CPU in float64, where
the device of the state picks the plain version, so no switch is needed.
Both sides start from the same reset (the card's, copied), take the same
step uniforms (`env.step(..., uniforms)`) and the same deterministic
actions, the JAX module's sinusoids.

Why float64 on the CPU and not the plain version on the card in float32:
the plain float32 version on the card departs from float64 by 0.12 at
degenerate states (a wall contact, PERF.md), so it is no fixed point to
measure from; `chip_smoke.py` phase 3c holds K3 the same way.

The bounds are about 10x the drift measured on an NVIDIA H100 80GB HBM3
at a 700.00 W power limit (`chip_smoke.py` phase 10c, 16 envs, 5 steps,
seed 0; PERF.md), max |obs_card - obs_float64| over the batch:

  env        step1      step5      note
  Env01-v2   5.7e-05    8.7e-04    the finite-difference pitch_dot obs
                                   divides by dt = 5 ms, so a state delta
                                   shows up x200 in the obs; step 2 reads
                                   1.9e-03
  Env03-v2   5.0e-06    4.2e-04    the 14-dof block scene

They are the H100's; the TPU's figures in the JAX module are no targets.
`chip_smoke.py` asserts them on every run (phase 10c).
"""

import numpy as np
import torch

# ~10x headroom over the measured values above
STEP1_BOUND = {"Env01-v2": 6e-4, "Env03-v2": 5e-5}
STEP5_BOUND = {"Env01-v2": 1e-2, "Env03-v2": 5e-3}
# the uniforms a step of each env takes: Env01-v2's pitch noise, Env03-v2's
# block launch
STEP_UNIFORMS = {"Env01-v2": 4, "Env03-v2": 6}


def _actions(t, batch):
    a = np.array([[0.3 * np.sin(0.1 * t), -0.2 * np.sin(0.13 * t)]],
                 np.float32)
    return torch.from_numpy(np.repeat(a, batch, 0))


def obs_drift(env_id, steps=5, batch=64, seed=0, device=None):
    """Per-step max|obs_measured - obs_float64| over `batch` envs. Element
    [0] is the reset obs (0.0: both sides share the reset); element [k] is
    after k control steps. The measured side runs on `device` (the card
    unless the caller names another) in float32."""
    import balance_robot_tpu_torch as brt
    from ..envs.base import tree_map

    env_m = brt.make(env_id, device=device, dtype=torch.float32,
                     seed=seed).use_fast_solver()
    env_r = brt.make(env_id, device="cpu", dtype=torch.float64,
                     seed=seed).use_fast_solver()
    state_m, obs_m = env_m.reset(batch)
    # the reference starts from the measured side's reset, each leaf in the
    # float64 env's own dtype
    like, _ = env_r.reset(batch)
    state_r = tree_map(lambda x, ref: x.to("cpu", ref.dtype), state_m, like)
    obs_r = obs_m.cpu()
    draws = torch.Generator().manual_seed(seed)
    out = [float((obs_m.cpu() - obs_r).abs().max())]
    for t in range(steps):
        u = torch.rand((batch, STEP_UNIFORMS[env_id]), generator=draws)
        a = _actions(t, batch)
        state_m, obs_m, _, _, _ = env_m.step(state_m, a.to(env_m.device), u)
        state_r, obs_r, _, _, _ = env_r.step(state_r, a, u)
        out.append(float((obs_m.cpu().double() - obs_r.double()).abs()
                         .max()))
    return out


def assert_drift_bounded(env_id, steps=5, batch=16, seed=0, device=None):
    """Raises AssertionError if the kernel on the card has drifted past the
    bounds above (also under `python -O`); returns the drift per step."""
    d = obs_drift(env_id, steps=steps, batch=batch, seed=seed, device=device)
    last = min(steps, 5)
    if d[0] != 0.0:
        raise AssertionError(f"reset obs differ: {d[0]:.3e}")
    if not d[1] < STEP1_BOUND[env_id]:
        raise AssertionError(f"{env_id} step-1 drift {d[1]:.3e} > "
                             f"{STEP1_BOUND[env_id]:.0e}")
    if not d[last] < STEP5_BOUND[env_id]:
        raise AssertionError(f"{env_id} step-{last} drift {d[last]:.3e} > "
                             f"{STEP5_BOUND[env_id]:.0e}")
    return d
