"""The plain reference agrees with the port's CPU path at a tiny size:
the same state, action and uniforms through the port's env step (its plain
physics on the CPU) and through the reference, both in float64; the
policy's mean and the frozen physics copy; the reference envs and the
solver grades are found by name."""

import numpy as np
import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp

from perf_bench import check, core
from perf_bench.reference import envs as ref_envs, mlp as ref_mlp


@pytest.mark.parametrize("env_id,grade", [("Env01-v2", "fast"),
                                          ("Env03-v2", "exact")])
def test_env_step_matches_the_port(env_id, grade):
    env = brt.make(env_id, device="cpu", dtype=torch.float64, seed=5)
    if grade == "fast":
        env.use_fast_solver()
    ref = ref_envs.load(env_id)(core.solver(grade))
    assert ref.params.newton_iters == env.params.newton_iters
    assert ref.params.ls_iters == env.params.ls_iters
    state, _ = env.reset(3)
    g = torch.Generator().manual_seed(9)
    action = torch.rand((3, 2), generator=g, dtype=torch.float64) * 2 - 1
    u = torch.rand((3, ref.n_uniforms), generator=g, dtype=torch.float64)
    out = env.step(state, action, u)
    cand = check.program_step(dict(out=out))
    truth = check.reference_step(ref, check.state_dict(state), action, u,
                                 torch.float64)
    numbers = check.step_numbers(cand, truth)
    assert numbers["flags"] == 0
    for name in ("qpos_p90", "qvel_p90", "reward"):
        assert numbers[name] < 1e-12, (name, numbers[name])
    # the obs is float32 in every dtype of the env
    assert numbers["obs"] < 1e-7
    for k in ("qpos", "qvel", "ws"):
        assert check.gap(cand[k], truth[k]) < 1e-12, k
    for k in ("t", "has_last", "last_t"):
        assert torch.equal(cand[k], truth[k])


def test_fresh_episodes_pass_the_reset_check():
    for env_id in ("Env01-v2", "Env03-v2"):
        env = brt.make(env_id, device="cpu", dtype=torch.float64, seed=2)
        state, obs = env.reset(64)
        ref = ref_envs.load(env_id)(core.solver("fast"))
        assert bool(ref.fresh(check.state_dict(state), obs.double()).all())


def test_policy_mean_matches_the_port():
    path = core.ROOT / "models/Env03-v2_r2i/best_model.npz"
    with np.load(path) as f:
        net = mlp.from_numpy_params({k: f[k] for k in f.files},
                                    dtype=torch.float64)
    obs = torch.randn((50, 6), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    p = ref_mlp.load(path, torch.float64, "cpu")
    assert torch.allclose(net.policy_mean(obs), ref_mlp.policy_mean(p, obs),
                          rtol=0, atol=1e-13)


def test_physics_copy_is_independent_of_the_port():
    import ast
    for path in (core.HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                top = node.module.split(".")[0]
            elif isinstance(node, ast.Import):
                top = node.names[0].name.split(".")[0]
            else:
                continue
            assert top in ("torch", "numpy", "math", "dataclasses",
                           "functools", "typing", "importlib", "sys",
                           "pathlib"), (path, top)


def test_reference_envs_and_grades_are_found_by_name():
    for env_id in ("Env01-v2", "Env03-v2"):
        cls = ref_envs.load(env_id)
        assert cls.id == env_id and ref_envs.load(env_id) is cls
    with pytest.raises(KeyError):
        ref_envs.load("Env99-v1")
    assert core.solver("exact") == {}
    assert core.solver("fast") == dict(newton_iters=4, ls_iters=6)
    with pytest.raises(KeyError):
        core.solver("turbo9")


def test_the_fast_grade_is_the_ports_own():
    env = brt.make("Env03-v2", device="cpu", seed=1)
    fast = brt.make("Env03-v2", device="cpu", seed=1).use_fast_solver()
    from dataclasses import replace
    assert replace(env.params, **core.solver("fast")) == fast.params
