"""The port's run drivers, PPO profiler and teacher-student recipe
(`train/train_run.py`, `train_offpolicy.py`, `profile_train.py`,
`widen_policy.py`, `distill_teacher.py`) against the JAX tools and the JAX
package, on the CPU; and the Env03 / EnvMove05 steps' constants.

  * options: each module's parser against the JAX tool's own, built by
    running the tool's parser lines (`tools/*.py`, from
    `argparse.ArgumentParser(` to `parse_args()`): the same options, kinds
    and defaults, less `--platform` and `--physics`, plus `--device`;
  * configs: `train_run`'s PPOConfig and `train_offpolicy`'s SAC / TD3 /
    DDPG configs for a fixed argv equal the JAX package's, field by field
    (the factories' cap of 256 envs included); the solver grades' iteration
    counts equal the JAX `fast_solver`'s;
  * the teacher's warm start from models/Env03-v2_r2i equals the JAX
    `mlp.pad_privileged_actor`'s arrays; `train_run.main` for one iteration
    on Env01-v2 writes the runner's artifacts; `train_offpolicy.main` on a
    toy env runs `--grad-steps` updates per iteration once past
    `--learning-starts`;
  * the widened r2i (`--priv`, 256 units) computes r2i's function through
    the JAX package's `mlp`, and its file loads in the JAX package;
  * DAgger: `update` on a fixed buffer with injected rows against a
    restatement of `tools/distill_teacher.py:172-194` with optax's Adam,
    and `collect` on Env03-v2 from one shared state with injected draws
    against a restatement of `:141-161` through the JAX package's env, both
    in float64; the beta schedule, the buffer's roll and the `best` rule on
    a toy env with a stubbed eval;
  * the profiler's four lines and its trace on a toy env, and the reading
    of a trace's kernels on a synthetic one;
  * no step of Env03-v2 or EnvMove05-v1 after the first builds a constant
    tensor (a blocking host-to-device copy on the card).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import balance_robot_tpu as jbrt
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.physics import fast_solver as jfast_solver
from balance_robot_tpu.train import checkpoint as jcheckpoint
from balance_robot_tpu.train.factory import algorithm_factory as jfactory
from balance_robot_tpu.train.ppo import PPOConfig as JPPOConfig

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import base
from balance_robot_tpu_torch.envs.privileged import PrivilegedObsEnv
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint, distill_teacher
from balance_robot_tpu_torch.train import offpolicy, profile_train
from balance_robot_tpu_torch.train import train_offpolicy
from balance_robot_tpu_torch.train import train_run, widen_policy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_env03 import jax_env, jax_state, start  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "models"
R2I = MODELS / "Env03-v2_r2i" / "best_model.npz"
TEACHER = MODELS / "Env03-v2_teacher" / "best_model.npz"
TOOLS = {train_run: "train_run.py", train_offpolicy: "train_offpolicy.py",
         profile_train: "profile_train.py", widen_policy: "widen_policy.py",
         distill_teacher: "distill_teacher.py"}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_tool_parser(name):
    """The JAX tool's own parser: its lines from `argparse.ArgumentParser(`
    up to `parse_args()`, run."""
    lines = (ROOT / "tools" / name).read_text().splitlines()
    first = next(i for i, s in enumerate(lines)
                 if "argparse.ArgumentParser(" in s)
    last = next(i for i, s in enumerate(lines) if "parse_args()" in s)
    scope = {"argparse": argparse}
    exec("\n".join(lines[first:last]), scope)
    return next(v for v in scope.values()
                if isinstance(v, argparse.ArgumentParser))


def options(parser):
    """{name: (default, type, choices, required, nargs, kind)} of a
    parser's arguments (an option by its first string, a positional by its
    dest), help left out."""
    return {(a.option_strings[0] if a.option_strings else a.dest):
            (a.default, a.type, a.choices and tuple(a.choices), a.required,
             a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("module", list(TOOLS), ids=list(TOOLS.values()))
def test_the_options_are_the_jax_tools(module):
    jax_opts = options(jax_tool_parser(TOOLS[module]))
    mine = options(module.build_parser())
    assert mine.pop("--device") == (None, None, ("cuda", "cpu"), False,
                                    None, "_StoreAction")
    for gone in ("--platform", "--physics"):
        jax_opts.pop(gone, None)
    assert mine == jax_opts
    if "--physics" in (ROOT / "tools" / TOOLS[module]).read_text():
        # no switch: the device of the tensors picks the kernel
        assert "--physics" in module.__doc__ and "no switch" in module.__doc__


def test_train_run_config_and_grades():
    argv = ["Env03-v2", "--envs", "512", "--steps", "16", "--mb", "256",
            "--epochs", "3", "--gamma", "0.999", "--ent-coef", "0.01",
            "--lr", "1e-4", "--privileged-critic"]
    args = train_run.build_parser().parse_args(argv)
    jargs = jax_tool_parser("train_run.py").parse_args(argv)
    # tools/train_run.py:70-73
    ref = JPPOConfig(n_envs=jargs.envs, n_steps=jargs.steps,
                     minibatch_size=jargs.mb, n_epochs=jargs.epochs,
                     gamma=jargs.gamma, ent_coef=jargs.ent_coef,
                     lr=jargs.lr, privileged_critic=jargs.privileged_critic)
    assert dataclasses.asdict(train_run.config(args)) == \
        dataclasses.asdict(ref)
    registered = jbrt.make("Env01-v2").params
    fast = jbrt.make("Env01-v2")
    fast.use_fast_solver()
    grades = {"exact": registered, "fast": fast.params,
              "turbo": jfast_solver(registered, newton_iters=2, ls_iters=4)}
    for solver, want in grades.items():
        env = train_run.make_env("Env01-v2", solver, "cpu")
        assert (env.params.newton_iters, env.params.ls_iters) == \
            (want.newton_iters, want.ls_iters), solver
    assert (grades["turbo"].newton_iters, grades["turbo"].ls_iters) == (2, 4)
    teacher_env = train_run.make_env("Env03-v2", "fast", "cpu", True)
    assert isinstance(teacher_env, PrivilegedObsEnv)
    assert teacher_env.obs_dim == 14


@pytest.mark.parametrize("algo", ["SAC", "TD3", "DDPG"])
@pytest.mark.parametrize("lr", [None, "5e-4"])
def test_train_offpolicy_config_is_the_jax_factorys(algo, lr):
    """The tool's overrides through both factories; 512 envs run 256."""
    argv = [algo, "Env01-v2", "--envs", "512", "--grad-steps", "4",
            "--batch", "128", "--buffer", "5000", "--gamma", "0.98",
            "--learning-starts", "300", "--privileged-critic"]
    if lr:
        argv += ["--lr", lr]
    args = train_offpolicy.build_parser().parse_args(argv)
    _, cfg = train_offpolicy.trainer_of(args, brt.make("Env01-v2",
                                                       device="cpu"))
    # tools/train_offpolicy.py:72-78
    jargs = jax_tool_parser("train_offpolicy.py").parse_args(argv)
    overrides = dict(gradient_steps=jargs.grad_steps,
                     batch_size=jargs.batch, buffer_size=jargs.buffer,
                     gamma=jargs.gamma,
                     learning_starts=jargs.learning_starts,
                     privileged_critic=jargs.privileged_critic)
    if jargs.lr is not None:
        overrides["lr"] = jargs.lr
    _, ref = jfactory(algo, jbrt.make("Env01-v2"), n_envs=jargs.envs,
                      **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.n_envs == 256 and cfg.gradient_steps == 4


def test_teacher_warm_start_is_the_jax_padding():
    env = train_run.make_env("Env03-v2", "fast", "cpu", True)
    mine = train_run.warm_start(R2I, env, True)
    ref = jmlp.pad_privileged_actor(jcheckpoint.load(R2I), 14)
    assert set(mine) == set(ref) and mine["pi_w1"].shape == (14, 64)
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=k)
    assert not mine["pi_w1"][6:].any()


def test_train_run_writes_the_tools_artifacts(tmp_path, monkeypatch,
                                              capsys):
    """One iteration of 4 envs x 2 steps; the eval after it and the
    checkpoint at 2 x eval_freq, on a 2-step horizon."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(brt.env_class("Env01-v2"), "max_episode_steps", 2)
    # no TensorBoard writer (its import takes seconds here)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    best, hist = train_run.main([
        "Env01-v2", "--envs", "4", "--steps", "2", "--mb", "8",
        "--epochs", "1", "--max-steps", "8", "--eval-freq", "4",
        "--eval-episodes", "1", "--run-name", "run", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == \
        "done; best saved under models/"
    run = tmp_path / "models" / "run"
    for name in ("best_model", "longest_model", "final_model", "cp_8",
                 "resume_state"):
        assert (run / f"{name}.npz").exists(), name
    assert (tmp_path / "logs" / "run.csv").exists() and len(hist) == 1
    saved = jcheckpoint.load(run / "best_model.npz")
    assert all(np.array_equal(saved[k], best[k]) for k in best)


class ToyState(NamedTuple):
    t: torch.Tensor
    x: torch.Tensor
    aux: dict


class ToyEnv:
    """obs = [x, t / 10, x^2, -x, 0, 1], privileged features [x, 1 - x];
    reward 1 - |x|; x moves by 0.3 a1 + 0.4 (u - 0.5), one uniform u per
    env and step; an episode ends at |x| > 1 or its 6-step horizon."""

    id = "Toy-v0"
    obs_dim = 6
    act_dim = 2
    priv_dim = 2
    max_episode_steps = 6

    def __init__(self, device=None, dtype=F64, seed=0):
        self.device, self.dtype = torch.device(device or "cpu"), dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def use_fast_solver(self):
        return self

    def _obs(self, s):
        z = torch.zeros_like(s.x)
        return torch.stack([s.x, s.t.to(self.dtype) / 10, s.x ** 2, -s.x, z,
                            z + 1], -1).float()

    def privileged(self, s):
        return torch.stack([s.x, 1 - s.x], -1).float()

    def reset(self, n):
        u = torch.rand(n, generator=self.generator, dtype=self.dtype)
        s = ToyState(t=torch.zeros(n, dtype=torch.int32), x=(u - 0.5) * 0.2,
                     aux={})
        return s, self._obs(s)

    def step(self, s, action, uniforms=None):
        u = torch.rand(action.shape[0], generator=self.generator,
                       dtype=self.dtype)
        x = s.x + 0.3 * action[:, 1].to(self.dtype) + 0.4 * (u - 0.5)
        s = s._replace(t=s.t + 1, x=x)
        return (s, self._obs(s), 1.0 - s.x.abs(), x.abs() > 1.0,
                s.t >= self.max_episode_steps)


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(brt._REGISTRY, ToyEnv.id, ToyEnv)


def test_train_offpolicy_runs_grad_steps_past_learning_starts(
        toy, tmp_path, monkeypatch, capsys):
    """4 envs: no update in the first 2 iterations (8 < 10 transitions),
    3 updates in each of the next 2."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    calls = []
    update = offpolicy.OffPolicy._update

    def counted(self, ts, idx=None, normals=None):
        calls.append(ts.steps)
        return update(self, ts, idx, normals)

    monkeypatch.setattr(offpolicy.OffPolicy,
                        "_update", counted)
    train_offpolicy.main([
        "SAC", "Toy-v0", "--envs", "4", "--grad-steps", "3", "--batch", "8",
        "--buffer", "64", "--learning-starts", "10", "--max-steps", "16",
        "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == \
        "done; artifacts under models/Toy-v0_SAC/"
    assert calls == [3, 3, 3, 4, 4, 4]
    run = tmp_path / "models" / "Toy-v0_SAC"
    assert (run / "final_model.npz").exists()
    with np.load(run / "resume_state.npz") as f:
        assert int(f["grad_steps"]) == 6 and int(f["ptr"]) == 16


def test_widened_r2i_keeps_its_function_in_jax(tmp_path, capsys):
    out = tmp_path / "wide" / "wide_init.npz"
    wide = widen_policy.main([str(R2I), "--env", "Env03-v2", "--priv",
                              "--hidden", "256", "--out", str(out),
                              "--device", "cpu"])
    assert capsys.readouterr().out.strip() == \
        f"exact wide copy: in 6->14, hidden 64->256 -> {out}"
    r2i = jcheckpoint.load(R2I)
    x = np.random.default_rng(1).standard_normal((64, 14)).astype(np.float32)
    for params in (wide, jcheckpoint.load(out)):
        assert params["pi_w1"].shape == params["vf_w1"].shape == (14, 256)
        np.testing.assert_allclose(jmlp.policy_mean(params, x),
                                   jmlp.policy_mean(r2i, x[:, :6]),
                                   atol=1e-5)
        np.testing.assert_allclose(jmlp.value(params, x),
                                   jmlp.value(r2i, x[:, :6]), atol=1e-4)
    saved = jcheckpoint.load(out)
    assert all(np.array_equal(saved[k], wide[k]) for k in wide)


def jax_update(student, obs, act, val, idx, lr, vf_coef):
    """tools/distill_teacher.py:172-194 with the minibatches' rows given."""
    optim = optax.adam(lr)
    opt_state = optim.init(student)
    losses = []
    for rows in idx:
        o, a, v = obs[rows], act[rows], val[rows]

        def loss_fn(p):
            loss = jnp.mean((jmlp.policy_mean(p, o) - a) ** 2)
            if vf_coef:
                loss = loss + vf_coef * jnp.mean((jmlp.value(p, o) - v) ** 2)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(student)
        updates, opt_state = optim.update(grads, opt_state, student)
        student = optax.apply_updates(student, updates)
        losses.append(loss)
    return student, jnp.mean(jnp.stack(losses))


@pytest.mark.parametrize("vf_coef", [0.0, 0.5])
def test_dagger_update_is_the_jax_tools(x64, vf_coef):
    env = brt.make("Env03-v2", device="cpu", dtype=F64)
    dag = distill_teacher.DAgger(env, checkpoint.load(TEACHER), envs=4,
                                 collect_steps=2, cap=32, vf_coef=vf_coef,
                                 epochs=3, mb=8)
    assert dag.n_minibatches() == 3
    rng = np.random.default_rng(3)
    rows = [(rng.normal(size=(12, 6)), rng.uniform(-1, 1, (12, 2)),
             rng.normal(size=12)) for _ in range(3)]
    held = [dag.insert(*(torch.tensor(x) for x in r)) for r in rows]
    assert held == [12, 24, 32]
    # the third batch wrapped: rows 24..31, then 0..3
    np.testing.assert_array_equal(dag.buf_obs[:4], rows[2][0][8:])
    np.testing.assert_array_equal(dag.buf_obs[12:24], rows[1][0])
    idx = rng.integers(0, dag.n, (3, 8))
    # a fresh student (`--student-hidden`): a trained critic's saturated
    # units have gradients near Adam's eps, where its step turns rounding
    # noise into a move of up to 1e-6 in either package
    teacher = checkpoint.load(TEACHER)
    student = distill_teacher.make_student(
        argparse.Namespace(init=None, student_hidden=32, seed=0), 6, 2,
        teacher, "cpu", F64)
    init = mlp.to_numpy_params(student)
    np.testing.assert_array_equal(init["log_std"], teacher["log_std"])
    opt = torch.optim.Adam(student.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = dag.update(student, opt, None, idx=torch.tensor(idx))
    ref, ref_loss = jax_update(
        {k: jnp.asarray(v, jnp.float64) for k, v in init.items()},
        *(jnp.asarray(b.numpy()) for b in (dag.buf_obs, dag.buf_act,
                                           dag.buf_val)),
        idx, 1e-3, vf_coef)
    mine = mlp.to_numpy_params(student)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-12)
    moved = {k for k in init if not np.array_equal(mine[k], init[k])}
    assert moved == ({k for k in init if k != "log_std"} if vf_coef
                     else {k for k in init if k.startswith("pi_")})


def test_dagger_collect_is_the_jax_tools(x64):
    """2 steps at B = 3 from start() of test_torch_env03 at t = 0: a block
    that parks, an impact, a parked block whose delay runs on (no launch
    in the two steps). Env 0 and 2 start driven by the teacher."""
    qpos, qvel, _, aux = start("Env03-v2")
    aux["delay_t0"] = np.zeros(3, np.float32)
    T, B = 2, 3
    rng = np.random.default_rng(5)
    obs0 = rng.normal(size=(B, 6)).astype(np.float32)
    drive = np.array([[[True], [False], [True]], [[False], [True], [True]]])
    noise = rng.normal(size=(T, B, 2))
    teacher, student = checkpoint.load(TEACHER), checkpoint.load(R2I)

    env = brt.make("Env03-v2", device="cpu", dtype=F64).use_fast_solver()
    dag = distill_teacher.DAgger(env, teacher, envs=B, collect_steps=T)
    states = env.state_from_qpos(torch.tensor(qpos), torch.tensor(qvel),
                                 aux=aux)
    _, _, d_obs, d_act, d_val = dag.collect(
        mlp.from_numpy_params(student, dtype=F64), states,
        torch.tensor(obs0), None, 1.0, drive=torch.tensor(drive),
        noise=torch.tensor(noise))
    assert d_obs.shape == (T * B, 6) and d_act.shape == (T * B, 2)

    # tools/distill_teacher.py:141-161, a step at a time with the draws
    # given; no episode ends, so the auto-reset obs is the step's
    jenv = jax_env("Env03-v2")
    js = jax_state(qpos, qvel, np.zeros(B, np.int32), aux,
                   jax.random.split(jax.random.PRNGKey(0), B))
    tp, sp = ({k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
              for p in (teacher, student))
    obs, ref = jnp.asarray(obs0), []
    for t in range(T):
        priv = jax.vmap(jenv.privileged)(js)
        aug = jnp.concatenate([obs, priv], axis=-1)
        t_act = jnp.clip(jmlp.policy_mean(tp, aug), -1.0, 1.0)
        s_act = jnp.clip(jmlp.policy_mean(sp, obs), -1.0, 1.0)
        act = jnp.where(drive[t], t_act, s_act)
        act = jnp.clip(act + 0.05 * noise[t], -1.0, 1.0)
        ref.append((obs, t_act, jmlp.value(tp, aug)))
        js, obs, _, term, trunc = jax.vmap(jenv.step)(js, act)
        assert not np.asarray(term | trunc).any()
    for mine, want in zip((d_obs, d_act, d_val), zip(*ref)):
        np.testing.assert_allclose(mine, np.concatenate(want), rtol=0,
                                   atol=1e-9)


def test_dagger_schedule_buffer_and_best_rule(toy, tmp_path, monkeypatch,
                                              capsys):
    """On the toy env with a privileged teacher and a fresh student: beta
    is 1 for --beta0 iterations, the buffer rolls at --cap, and a stubbed
    eval's scores pick the best by full-horizon share, then return."""
    teacher = mlp.to_numpy_params(mlp.ActorCritic(
        8, 2, hidden=16, generator=torch.Generator().manual_seed(0)))
    teacher["log_std"] = np.array([-1.5, -0.5], np.float32)
    checkpoint.save(tmp_path / "teacher", teacher)
    scores = iter([(0.5, 10.0), (0.6, 5.0), (0.6, 4.0), (0.6, 7.0)])
    betas = []

    def fake_eval(env, act_fn, net, seed, n, max_steps=None):
        assert (env.obs_dim, seed, n, max_steps) == (6, 0, 8, 6)
        full, ret = next(scores)
        return full, ret, 3.0, None, None

    collect = distill_teacher.DAgger.collect

    def seen(self, student, states, obs, gen, beta, drive=None, noise=None):
        betas.append(beta)
        return collect(self, student, states, obs, gen, beta, drive, noise)

    monkeypatch.setattr(distill_teacher.selection, "paired_eval", fake_eval)
    monkeypatch.setattr(distill_teacher.DAgger, "collect", seen)
    out = tmp_path / "out"
    res = distill_teacher.main([
        "--env", "Toy-v0", "--teacher", str(tmp_path / "teacher.npz"),
        "--student-hidden", "16", "--out", str(out), "--envs", "4",
        "--collect-steps", "2", "--iters", "3", "--beta0", "2", "--mb", "4",
        "--epochs", "1", "--cap", "20", "--eval-every", "1",
        "--eval-episodes", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert betas == [1.0, 1.0, 0.0]
    assert lines[0] == "[dagger] init None: full=50.0% ret=10 len=3"
    for it, (beta, n) in enumerate(((1, 8), (1, 16), (0, 20))):
        assert lines[1 + 2 * it].startswith(
            f"[dagger {it}] beta={beta} buffer={n} heldout-gap=")
    assert [line.endswith("<-- new best") for line in lines[2:7:2]] == \
        [True, False, True]
    assert res["best"] == dict(full=0.6, ret=7.0, it=2)
    assert lines[-1] == f"[dagger] best: it=2 full=60.0% ret=7 -> " \
                        f"{out}/best_model.npz"
    best, final = (checkpoint.load(out / f"{n}.npz")
                   for n in ("best_model", "final_model"))
    assert all(np.array_equal(best[k], final[k]) for k in final)
    # the fresh student took the teacher's log_std, which the loss does
    # not reach
    np.testing.assert_array_equal(final["log_std"], teacher["log_std"])
    assert final["pi_w1"].shape == (6, 16)
    assert distill_teacher.better(0.6, 7.0, res["best"]) is False
    assert distill_teacher.better(0.7, 0.0, res["best"]) is True


def test_profiler_prints_the_tools_lines_and_a_trace(toy, tmp_path,
                                                     capsys):
    res = profile_train.main([
        "--env-id", "Toy-v0", "--envs", "4", "--steps", "2", "--mb", "8",
        "--reps", "1", "--trace", str(tmp_path), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "config: 4 envs x 2 steps, mb=8, backend=cpu"
    for line, name in zip(lines[1:5], ("rollout-only", "gae+update-only",
                                       "full iteration",
                                       "overhead (iter - roll - upd)")):
        assert line.startswith(name)
    assert lines[1].endswith("env-steps/s") and lines[3].endswith(
        "env-steps/s")
    assert lines[5] == f"trace written to {tmp_path}"
    assert [line.split()[1] for line in lines[6:]] == list(
        profile_train.PHASES)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    for phase in res["trace"].values():
        assert phase["kernels"] == 0 and phase["wall_ms"] > 0
    assert res["trace"]["iteration"]["wall_ms"] >= \
        res["trace"]["update"]["wall_ms"]
    assert min(res[k] for k in ("rollout", "update", "iteration")) > 0


def test_read_trace_merges_a_phases_kernels(tmp_path):
    """Kernels by the runtime call that launched them: two overlapping
    kernels of the update count once, a kernel launched before a phase
    belongs to the iteration only, and the window runs to the last
    kernel's end."""
    def span(name, ts, dur):
        return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)

    def launch(corr, ts, name="k", start=0.0, dur=0.0):
        return [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                     ts=ts, dur=1, args=dict(correlation=corr)),
                dict(ph="X", cat="kernel", name=name, ts=start, dur=dur,
                     args=dict(correlation=corr))]

    events = [span("iteration", 0, 100), span("rollout", 0, 40),
              span("update", 50, 50),
              *launch(1, 10, "step", 20, 30), *launch(2, 60, "gemm", 70, 20),
              *launch(3, 61, "gemm", 80, 20), *launch(4, 62, "adam", 120, 5),
              *launch(5, 45, "gae", 48, 2)]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    out = profile_train.read_trace(path)
    assert out["rollout"]["kernels"] == 1
    assert out["rollout"]["busy_ms"] == pytest.approx(0.030)
    assert out["rollout"]["wall_ms"] == pytest.approx(0.050)
    assert out["update"]["kernels"] == 3
    assert out["update"]["busy_ms"] == pytest.approx(0.035)
    assert out["update"]["wall_ms"] == pytest.approx(0.075)
    assert out["update"]["top"][0] == ("gemm", pytest.approx(0.040), 2)
    assert out["iteration"]["kernels"] == 5
    assert out["iteration"]["busy_ms"] == pytest.approx(0.065)


@pytest.mark.parametrize("env_id", ["Env03-v2", "EnvMove05-v1"])
def test_no_step_after_the_first_builds_a_constant(monkeypatch, env_id):
    """A constant built in a step is a blocking host-to-device copy on
    the card: the envs make theirs once per device and dtype."""
    env = brt.make(env_id, device="cpu").use_fast_solver()
    s, obs = env.reset(1)
    a = torch.zeros(1, 2)
    s = env.step(s, a)[0]
    built = []
    envs_dir = str(Path(base.__file__).parent)
    tensor = torch.tensor

    def spy(*args, **kwargs):
        if sys._getframe(1).f_code.co_filename.startswith(envs_dir):
            built.append(sys._getframe(1).f_code.co_name)
        return tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", spy)
    env.step(s, a)
    assert built == []
    names = {k[0] for k in base._CONSTANTS if k[1:] == (torch.device("cpu"),
                                                        torch.float32)}
    assert names >= ({"PARK_POS"} if env_id == "Env03-v2"
                     else {"WALLS", "RAY_DIRS_LOCAL"})
    if env_id == "Env03-v2":
        assert base.device_constant("PARK_POS", None, "cpu",
                                    torch.float32).tolist() == [10, 10, 0]
