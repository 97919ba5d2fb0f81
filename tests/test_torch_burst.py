"""The burst ratchet's control flow (`train/burst.py`) and the paired eval
(`train/selection.py`), on the CPU.

A tiny torch toy env with the port's env interface stands in for the
physics, in the manner of `tests/test_torch_runner.py`: x starts near 0,
moves by 0.3 a1 plus a uniform draw each step, and an episode ends when
|x| > 1 (terminated) or at its 6-step horizon. It has an attack side and
the env hooks the hardening uses (`_reward`, `_uniform`, `back_frac`,
`carry_across_reset`). The ratchet runs on it with the checked-in
`models/Env01-v2_PPO` as the incumbent (6 obs, 2 actions):

  * a forced accept (`--min-win -1`, as `tests/test_burst_gate.py`
    forces it) with `--confirm`, so the confirm set and the pooled gate
    run, and `burst_history.json` has the keys of the JAX tool's histories
    (`models/Env03-v2_r2i/burst_history.json`) and of that test;
  * `--min-win 1` keeps every burst dry, so the learning rate decays;
  * `--max-wall 0` runs no burst;
  * the failure replay and the hardening on a fake harvest of toy states;
  * `best_model.npz` loads in the JAX package's `checkpoint.load`.
"""

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from balance_robot_tpu.train import checkpoint as jcheckpoint

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs.hardened import ReplayResetEnv
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import burst, checkpoint, harvest
from balance_robot_tpu_torch.train import selection
from balance_robot_tpu_torch.train.ppo import deterministic_action

torch.set_num_threads(1)
F64 = torch.float64
MODELS = Path(__file__).resolve().parents[1] / "models"
INIT = MODELS / "Env01-v2_PPO" / "best_model.npz"


class ToyState(NamedTuple):
    t: torch.Tensor         # (B,) int32
    last_t: torch.Tensor    # (B,) float32
    x: torch.Tensor         # (B,)
    aux: dict


class ToyEnv:
    """obs = [x, t / 10, x^2, -x, 0, 1]; reward 1 - |x|; x moves by
    0.3 a1 + 0.4 (u - 0.5) for one uniform u per env and step."""

    id = "Toy-v0"
    obs_dim = 6
    act_dim = 2
    max_episode_steps = 6
    back_frac = 0.5

    def __init__(self, device=None, dtype=F64, seed=0):
        self.device, self.dtype = torch.device(device or "cpu"), dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def use_fast_solver(self):
        return self

    def _uniform(self, *shape):
        return torch.rand(shape, generator=self.generator, dtype=self.dtype)

    def _obs(self, s):
        z = torch.zeros_like(s.x)
        return torch.stack([s.x, s.t.to(self.dtype) / 10, s.x ** 2, -s.x, z,
                            z + 1], -1).float()

    def reset(self, n):
        u = self._uniform(n, 2)
        s = ToyState(t=torch.zeros(n, dtype=torch.int32),
                     last_t=torch.zeros(n), x=(u[:, 0] - 0.5) * 0.2,
                     aux={"attack_front": u[:, 1] > self.back_frac})
        return s, self._obs(s)

    def carry_across_reset(self, old, new):
        return new._replace(aux={**new.aux,
                                 "attack_front": old.aux["attack_front"]})

    def _reward(self, s, u):
        return 1.0 - s.x.abs()

    def step(self, s, action, uniforms=None):
        u = self._uniform(action.shape[0]) if uniforms is None else uniforms
        reward = self._reward(s, u)
        x = s.x + 0.3 * action[:, 1].to(self.dtype) + 0.4 * (u - 0.5)
        s = s._replace(t=s.t + 1, x=x)
        return (s, self._obs(s), reward, x.abs() > 1.0,
                s.t >= self.max_episode_steps)


@pytest.fixture(autouse=True)
def toy_registered(monkeypatch):
    monkeypatch.setitem(brt._REGISTRY, ToyEnv.id, ToyEnv)


def ratchet(tmp_path, *extra, bursts=1):
    argv = ["--env", ToyEnv.id, "--init", str(INIT),
            "--out", str(tmp_path / "out"), "--device", "cpu",
            "--bursts", str(bursts), "--burst-steps", "32",
            "--snap-steps", "16", "--envs", "4", "--steps", "4", "--mb", "8",
            "--epochs", "1", "--eval-episodes", "8", *extra]
    result = burst.main(argv)
    hist = json.loads((tmp_path / "out" / "burst_history.json").read_text())
    assert hist == json.loads(json.dumps(result["history"]))
    return result, hist


def test_the_options_are_the_jax_tools():
    """Every option and default of tools/burst_refine.py, with --device in
    place of --platform."""
    src = (MODELS.parent / "tools" / "burst_refine.py").read_text()
    jax_opts = {line.split('"')[1] for line in src.splitlines()
                if line.strip().startswith('ap.add_argument("--')}
    actions = {a.option_strings[0]: a for a in burst.build_parser()._actions
               if a.option_strings and a.dest != "help"}
    assert set(actions) == jax_opts - {"--platform"} | {"--device"}
    args = burst.build_parser().parse_args(["--init", "x"])
    assert (args.env, args.out, args.bursts, args.burst_steps,
            args.snap_steps, args.lr, args.lr_decay, args.epochs,
            args.ent_coef, args.envs, args.steps, args.mb, args.gamma,
            args.eval_episodes, args.min_win, args.seed, args.max_wall,
            args.replay_frac, args.failure_replay, args.device) == (
        "Env03-v2", "models/Env03-v2_r2b", 6, 12_000_000, 1_000_000, 5e-5,
        0.7, 10, 0.0, 1024, 32, 1024, 0.999, 512, None, 0, 7200, 0.25, 0,
        None)


def test_forced_accept_runs_the_confirm_set_and_the_gate(tmp_path, capsys):
    result, hist = ratchet(tmp_path, "--confirm", "--min-win", "-1.0",
                           bursts=2)
    out = capsys.readouterr().out
    # the JAX tool's histories and test_burst_gate's keys
    ref = json.loads((MODELS / "Env03-v2_r2i" /
                      "burst_history.json").read_text())
    assert set(ref) <= set(hist) and {"accepted", "min_win"} <= set(hist)
    assert set(ref["best"]) <= set(hist["best"])
    assert {"cscore", "pooled"} <= set(hist["best"])
    assert set(hist["best"]["pooled"]) == {"incumbent", "winner"}
    assert hist["min_win"] == -1.0
    assert len(hist["history"]) == 4
    for row in hist["history"]:
        assert set(ref["history"][0]) <= set(row)
        assert row["lr"] == 5e-5 and row["steps"] in (16, 32)
    if hist["accepted"]:
        assert hist["best"]["src"].startswith("burst")
        assert hist["best"]["pooled"]["winner"] >= \
            hist["best"]["pooled"]["incumbent"]
    else:
        assert hist["best"]["reverted_by_gate"] is True
        assert hist["best"]["pooled"]["winner"] < \
            hist["best"]["pooled"]["incumbent"]
    assert "[gate] incumbent pooled fresh-seed (2x8)" in out
    assert "DONE accepted=" in out and "new best (confirmed)" in out
    # best_model.npz is the artifact's params, in either package
    saved = checkpoint.load(tmp_path / "out" / "best_model.npz")
    assert all(np.array_equal(saved[k], result["params"][k])
               for k in result["params"])
    jax_saved = jcheckpoint.load(tmp_path / "out" / "best_model.npz")
    init = jcheckpoint.load(INIT)
    assert set(jax_saved) == set(init)
    assert all(jax_saved[k].shape == init[k].shape for k in init)


def test_dry_bursts_decay_the_learning_rate(tmp_path, capsys):
    result, hist = ratchet(tmp_path, "--confirm", "--min-win", "1.0",
                           "--lr-decay", "0.5", bursts=2)
    out = capsys.readouterr().out
    assert hist["accepted"] is False and "pooled" not in hist["best"]
    assert hist["best"]["src"] == str(INIT) and hist["min_win"] == 1.0
    assert [row["lr"] for row in hist["history"]] == [5e-5] * 2 + [2.5e-5] * 2
    assert out.count("no improvement -> lr") == 2
    saved = checkpoint.load(tmp_path / "out" / "best_model.npz")
    init = checkpoint.load(INIT)
    assert all(np.array_equal(saved[k], init[k]) for k in init)


def test_auto_min_win_and_max_wall(tmp_path, capsys):
    """Without --min-win the margin is 2 s.e. of the incumbent's rate;
    --max-wall 0 runs no burst."""
    _, hist = ratchet(tmp_path, "--confirm", "--max-wall", "0", bursts=3)
    out = capsys.readouterr().out
    assert "[burst] wall budget reached" in out
    assert hist["history"] == [] and hist["accepted"] is False
    assert hist["min_win"] == selection.auto_min_win(hist["best"]["score"], 8)
    assert "cscore" in hist["best"]


@pytest.mark.parametrize("p", [0.01, 0.5, 0.87, 0.99])
def test_auto_min_win_is_two_standard_errors(p):
    q = min(max(p, 0.05), 0.95)
    assert selection.auto_min_win(p, 512) == pytest.approx(
        2 * math.sqrt(q * (1 - q) / 512), rel=1e-15)


def test_failure_replay_and_hardening_train_on_the_bank(tmp_path,
                                                        monkeypatch):
    """--failure-replay harvests from the current best at seed + 55 + b
    and trains on ReplayResetEnv over the hardened env; an empty bank
    keeps the plain resets."""
    calls, envs = [], []

    def fake_harvest(env, params, episodes, seed):
        calls.append((episodes, seed, params["pi_w1"].shape))
        n = 0 if len(calls) == 2 else 3
        bank = ToyState(t=torch.full((n,), 4, dtype=torch.int32),
                        last_t=torch.full((n,), 0.02),
                        x=torch.full((n,), 0.9, dtype=F64),
                        aux={"attack_front": torch.ones(n, dtype=torch.bool)})
        return bank, dict(n_bank=n, episodes=episodes, full_rate=0.5,
                          obs=torch.zeros(n, 6))

    init = burst.PPO.init

    def spy_init(self, seed, params=None):
        envs.append(self.env)
        return init(self, seed, params)

    monkeypatch.setattr(harvest, "harvest_fatal_states", fake_harvest)
    monkeypatch.setattr(burst.PPO, "init", spy_init)
    result, hist = ratchet(tmp_path, "--failure-replay", "16",
                           "--replay-frac", "0.5", "--survival-reward",
                           "--train-back-frac", "0.7", bursts=2)
    assert calls == [(16, 55, (6, 64)), (16, 56, (6, 64))]
    assert result["banks"] == [3, 0]
    wrap, plain = envs
    assert isinstance(wrap, ReplayResetEnv) and wrap.frac == 0.5
    assert not isinstance(plain, ReplayResetEnv)
    assert plain.back_frac == 0.7 and wrap._env is plain
    # 4 envs: the first reset and a reset candidate per rollout step
    assert wrap.resets == 4 * (1 + 8) and 0 < int(wrap.replayed) < 36
    s, _ = plain.reset(4)
    r = plain.step(s, torch.zeros(4, 2))[2]
    assert torch.equal(r, torch.ones(4, dtype=F64))
    assert len(hist["history"]) == 4


def test_paired_eval_sees_the_same_episodes_whatever_the_policy():
    env = ToyEnv(seed=3)
    starts = []
    nets = [mlp.from_numpy_params(checkpoint.load(INIT), dtype=F64),
            mlp.ActorCritic(generator=torch.Generator().manual_seed(1),
                            dtype=F64)]
    outs = [selection.paired_eval(
        env, deterministic_action, net, 5, 16,
        on_start=lambda s, o: starts.append((s, o))) for net in nets]
    assert torch.equal(starts[0][0].x, starts[1][0].x)
    assert torch.equal(starts[0][1], starts[1][1])
    again = selection.paired_eval(env, deterministic_action, nets[0], 5, 16)
    for a, b in zip(outs[0], again):
        np.testing.assert_array_equal(a, b)
    full, ret, length, rets, lens = outs[0]
    assert full == float((lens >= 6).mean()) and length == lens.mean()
    assert rets.shape == lens.shape == (16,)
    # another seed, other episodes; the env's own generator is untouched
    other = selection.paired_eval(env, deterministic_action, nets[0], 6, 16)
    assert not np.array_equal(other[3], outs[0][3])
    assert torch.equal(env.generator.get_state(),
                       ToyEnv(seed=3).generator.get_state())


def test_the_ratchet_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        burst.main(["--env", ToyEnv.id, "--init", str(INIT),
                    "--out", str(tmp_path)])
