"""The port's rollout bookkeeping, runner, guards and profiling, on the CPU.

A tiny deterministic toy env with the port's env interface stands in for
the physics (a real control step takes seconds on a CPU): each env's
episodes end by truncation at 3 steps, and env 1 also terminates at step
2, env 2 at step 3 (terminated and truncated at once). The rollout's
stored rewards, actions and episode statistics are held to a hand
computation from what the env returned; the runner's eval gate, its
artifacts, its threshold stop and its resume run on the toy env; a
port-saved best_model loads in the JAX package.
"""

import csv
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.train import checkpoint as jcheckpoint

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint, runner
from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
from balance_robot_tpu_torch.envs.privileged import PrivilegedObsEnv
from balance_robot_tpu_torch.train.ppo import (PPO, PPOConfig,
                                               deterministic_action, fork_env)
from balance_robot_tpu_torch.utils.guards import (assert_finite_tree,
                                                  checked_step)
from balance_robot_tpu_torch.utils.profiling import Timer, trace

torch.set_num_threads(1)
F64 = torch.float64


class ToyPhys(NamedTuple):
    qpos: torch.Tensor


class ToyState(NamedTuple):
    t: torch.Tensor     # (B,) int32 steps this episode
    x: torch.Tensor     # (B,)

    @property
    def phys(self):
        """What a recording reads: qpos (B, 2) = [x, t]."""
        return ToyPhys(torch.stack((self.x, self.t.to(self.x.dtype)), -1))


class ToyEnv:
    """obs = [x, t / 10, x^2, -x, 0, 1]; reward 1 + x - a0^2 on the env's
    (clipped) action; x moves by 0.1 a1. Env b terminates at step
    TERM_AT[b % 3] of its episode (0: never), every env truncates at 3."""

    id = "Toy-v0"
    obs_dim = 6
    act_dim = 2
    max_episode_steps = 3
    reward_threshold = 1e9
    TERM_AT = (0, 2, 3)

    def __init__(self, device="cpu", dtype=F64, seed=0, nan_env=None):
        self.device, self.dtype = torch.device(device), dtype
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.nan_env = nan_env
        self.log = []           # (action, reward, term, trunc, obs) per step

    def _obs(self, s):
        z = torch.zeros_like(s.x)
        return torch.stack([s.x, s.t.to(self.dtype) / 10, s.x ** 2, -s.x, z,
                            z + 1], -1).float()

    def reset(self, n):
        s = ToyState(t=torch.zeros(n, dtype=torch.int32),
                     x=torch.rand(n, generator=self.generator,
                                  dtype=self.dtype))
        return s, self._obs(s)

    def step(self, s, action, uniforms=None):
        n = action.shape[0]
        a = action.to(self.dtype)
        reward = 1.0 + s.x - a[:, 0] ** 2
        if self.nan_env is not None:
            reward[self.nan_env] = float("nan")
        s = ToyState(t=s.t + 1, x=s.x + 0.1 * a[:, 1])
        term_at = torch.tensor(self.TERM_AT)[torch.arange(n) % 3]
        term = (term_at > 0) & (s.t >= term_at)
        trunc = s.t >= self.max_episode_steps
        obs = self._obs(s)
        self.log.append((action.clone(), reward, term, trunc, obs))
        return s, obs, reward, term, trunc


CFG = PPOConfig(n_envs=3, n_steps=4, minibatch_size=4, n_epochs=1,
                gamma=0.9)


# ------------------------------------------------------------- rollout

def test_rollout_bookkeeping():
    env = ToyEnv()
    ppo = PPO(env, PPOConfig(n_envs=3, n_steps=7, gamma=0.9))
    ts = ppo.init(0)
    with torch.no_grad():
        ts.net.log_std.fill_(1.0)     # samples beyond [-1, 1]
    env.log.clear()
    ts2, traj = ppo._rollout(ts)
    assert len(env.log) == 7
    ep_ret, ep_len = torch.zeros(3, dtype=F64), torch.zeros(3)
    stat_sum, stat_n = 0.0, 0
    kinds = set()
    for t, (action, raw, term, trunc, term_obs) in enumerate(env.log):
        # the env got the clipped sample, the trajectory holds the sample
        assert torch.equal(action, traj["actions"][t].clamp(-1, 1))
        boot = trunc & ~term
        with torch.no_grad():
            v_term = ts.net.value(term_obs.to(F64))
        expect = raw + torch.where(boot, 0.9 * v_term, 0.0)
        assert torch.equal(traj["reward"][t], expect)
        assert torch.equal(traj["done"][t], term | trunc)
        kinds |= {(bool(a), bool(b)) for a, b in zip(term, trunc)}
        ep_ret, ep_len = ep_ret + raw, ep_len + 1
        done = term | trunc
        stat_sum += float(ep_ret[done].sum())
        stat_n += int(done.sum())
        ep_ret[done], ep_len[done] = 0.0, 0
    # a truncation, a termination and both at once took place
    assert {(False, True), (True, False), (True, True)} <= kinds
    assert (traj["actions"].abs() > 1).any()
    torch.testing.assert_close(ts2.ep_ret, ep_ret, rtol=0, atol=1e-12)
    assert torch.equal(ts2.ep_len, ep_len.to(torch.int32))
    torch.testing.assert_close(float(ts2.stat_sum_ret), stat_sum, rtol=0,
                               atol=1e-12)
    assert float(ts2.stat_n_eps) == stat_n


# ------------------------------------------------------------- runner

def train(tmp_path, **kw):
    args = dict(seed=0, eval_freq=12, ckpt_freq=24, n_eval_episodes=2,
                models_dir=tmp_path / "models", logs_dir=tmp_path / "logs",
                run_name="toy", verbose=False,
                movies_dir=tmp_path / "movies")
    args.update(kw)
    return runner.train(args.pop("env", None) or ToyEnv(),
                        args.pop("config", CFG), **args)


def test_runner_artifacts_csv_and_recordings(tmp_path):
    best, history = train(tmp_path, total_timesteps=36, record_every=2)
    assert [row["steps"] for row in history] == [12, 24, 36]
    run = tmp_path / "models" / "toy"
    for name in ("best_model", "longest_model", "cp_24", "final_model",
                 "resume_state"):
        assert (run / f"{name}.npz").exists(), name
    with open(tmp_path / "logs" / "toy.csv") as f:
        rows = list(csv.reader(f))
    assert tuple(rows[0]) == runner.CSV_COLUMNS and len(rows) == 4
    with np.load(tmp_path / "movies" / "toy_24.npz") as f:
        qpos = f["qpos"]
    # one episode of the eval env: its 3 steps, or 2 where it terminates
    assert qpos.shape in ((3, 2), (2, 2))
    np.testing.assert_array_equal(qpos[:, 1], np.arange(1, len(qpos) + 1))
    saved = checkpoint.load(run / "best_model")
    assert sorted(saved) == sorted(best)
    assert checkpoint.load_train_state(
        run / "resume_state.npz", PPO(ToyEnv(), CFG).init(3))[1] == 36


def test_runner_stops_at_the_reward_threshold(tmp_path):
    _, history = train(tmp_path, total_timesteps=120, reward_threshold=-1.0)
    assert [row["steps"] for row in history] == [12]
    assert (tmp_path / "models" / "toy" / "final_model.npz").exists()


class Scripted(PPO):
    """PPO whose evaluations return a script of (return, length), and
    keep the params each was given."""

    def __init__(self, env, cfg, script):
        super().__init__(env, cfg)
        self.script, self.seen = list(script), []

    def evaluate(self, net, n_episodes, max_steps=None):
        self.seen.append(mlp.to_numpy_params(net))
        return self.script.pop(0)


def test_eval_gate_keeps_the_best_after_a_warm_start(tmp_path):
    run = tmp_path / "models" / "toy"
    init = mlp.to_numpy_params(mlp.ActorCritic(
        generator=torch.Generator().manual_seed(1), dtype=F64))
    # a worse eval after the warm start's own writes no best_model
    checkpoint.save(run / "best_model", {"sentinel": np.ones(1)})
    trainer = Scripted(ToyEnv(), CFG, [(10.0, 3.0), (5.0, 3.0)])
    train(tmp_path, total_timesteps=12, init_params=init, trainer=trainer)
    assert sorted(checkpoint.load(run / "best_model")) == ["sentinel"]
    assert not (run / "longest_model.npz").exists()
    # a better one does, and the longest episode picks longest_model
    trainer = Scripted(ToyEnv(), CFG,
                       [(10.0, 3.0), (5.0, 4.0), (12.0, 2.0), (3.0, 1.0)])
    best, _ = train(tmp_path, total_timesteps=36, init_params=init,
                    trainer=trainer, run_name="toy2")
    run = tmp_path / "models" / "toy2"
    for name, call in (("best_model", 2), ("longest_model", 1)):
        saved = checkpoint.load(run / name)
        for k, v in trainer.seen[call].items():
            np.testing.assert_array_equal(saved[k], v, err_msg=name)
    for k, v in trainer.seen[2].items():
        np.testing.assert_array_equal(best[k], v)


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """Evaluations draw from their own generator, so a run stopped at 24
    steps and resumed to 48 ends on the params of a run that went to 48
    at once (with an eval every 12 steps in both)."""
    train(tmp_path, total_timesteps=48, run_name="whole")
    train(tmp_path, total_timesteps=24, run_name="cut")
    _, history = train(tmp_path, total_timesteps=48, run_name="cut",
                       resume=True)
    assert [row["steps"] for row in history] == [36, 48]
    whole = checkpoint.load(tmp_path / "models" / "whole" / "final_model")
    cut = checkpoint.load(tmp_path / "models" / "cut" / "final_model")
    for k in whole:
        np.testing.assert_array_equal(cut[k], whole[k], err_msg=k)


def test_evaluation_leaves_the_training_generator_alone():
    env = ToyEnv()
    ppo = PPO(env, CFG)
    ts = ppo.init(0)
    before = env.generator.get_state()
    ppo.evaluate(ts.net, 4)
    qpos_len = ppo.evaluator.env.max_episode_steps
    assert qpos_len == 3 and torch.equal(env.generator.get_state(), before)
    assert ppo.eval_env.generator is not env.generator


def test_fork_env_draws_from_its_own_generator():
    env = brt.make("Env03-v2", device="cpu")
    teacher = PrivilegedObsEnv(env)
    for twin, obs_dim in ((fork_env(env, 7), 6), (fork_env(teacher, 7), 14)):
        assert twin.generator is not env.generator
        assert twin.params is env.params and twin.obs_dim == obs_dim
        before = env.generator.get_state()
        twin.reset(2)
        assert torch.equal(env.generator.get_state(), before)


def test_load_into_restores_a_nested_tree(tmp_path):
    tree = {"actor": [{"w": torch.arange(6.0).reshape(2, 3)},
                      {"b": np.arange(3.0)}], "log_alpha": torch.tensor(0.5)}
    checkpoint.save(tmp_path / "nested", tree)
    like = {"actor": [{"w": torch.zeros(2, 3, dtype=F64)},
                      {"b": np.zeros(3)}],
            "log_alpha": torch.tensor(0.0)}
    back = checkpoint.load_into(tmp_path / "nested.npz", like)
    assert back["actor"][0]["w"].dtype == F64
    torch.testing.assert_close(back["actor"][0]["w"],
                               tree["actor"][0]["w"].double())
    np.testing.assert_array_equal(back["actor"][1]["b"], np.arange(3.0))
    assert float(back["log_alpha"]) == 0.5


def test_best_model_loads_in_the_jax_package(tmp_path):
    best, _ = train(tmp_path, total_timesteps=12,
                    env=ToyEnv(dtype=torch.float32))
    params = jcheckpoint.load(tmp_path / "models" / "toy" / "best_model")
    obs = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    ref = np.asarray(jmlp.policy_mean(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(obs)))
    with torch.no_grad():
        mine = mlp.from_numpy_params(best).policy_mean(torch.tensor(obs))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_a_nan_reward_stops_the_eval_gate(tmp_path):
    env = ToyEnv(nan_env=1)
    net = mlp.ActorCritic(generator=torch.Generator().manual_seed(0),
                          dtype=F64)
    with pytest.raises(FloatingPointError, match="1 of 3 evaluation"):
        ChunkedEvaluator(env, deterministic_action).evaluate(net, 3)
    with pytest.raises(FloatingPointError, match="non-finite return"):
        train(tmp_path, total_timesteps=12, env=ToyEnv(nan_env=0))


# ---------------------------------------------------- guards, profiling

def test_checked_step_clean_and_poisoned():
    env = brt.make("Env01-v1", device="cpu")
    state, _ = env.reset(1)
    step = checked_step(env)
    step(state, torch.zeros(1, 2))
    bad = state._replace(phys=state.phys._replace(
        qvel=torch.full_like(state.phys.qvel, float("nan"))))
    with pytest.raises(FloatingPointError, match="non-finite q"):
        step(bad, torch.zeros(1, 2))


def test_assert_finite_tree_names_the_bad_leaves():
    assert_finite_tree({"w": torch.ones(3), "n": [np.zeros(2)]}, "params")
    with pytest.raises(FloatingPointError, match=r"params at: b, n/1"):
        assert_finite_tree({"w": torch.ones(3),
                            "b": torch.tensor([1.0, float("nan")]),
                            "n": [np.zeros(2), np.array([np.inf])],
                            "i": np.arange(3)}, "params")
    net = mlp.ActorCritic()
    with torch.no_grad():
        net.vf_l1.bias[0] = float("inf")
    with pytest.raises(FloatingPointError, match="vf_l1.bias"):
        assert_finite_tree(net, "params")


def test_timer_throughput_and_trace_on_the_cpu(tmp_path):
    timer = Timer("cpu")
    for _ in range(2):
        with timer("phase"):
            torch.ones(8).sum()
    report = timer.report()
    assert report["phase"]["n"] == 2 and report["phase"]["total_s"] >= 0
    with trace(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert list((tmp_path / "trace").glob("*.json"))
