"""The port's CLI against the JAX package's (CPU).

  * every command and option the two share has the same flags and the
    same default, read from the JAX package's click objects;
  * `_run_episodes` prints the same lines (episode returns, grace steps,
    Cal01-style telemetry, --show-io / --show-i) and records the same
    trajectory as the JAX package's, on a stub env written for each
    package with the same arithmetic in float32;
  * `_serial_act` speaks the same protocol over a loopback;
  * the commands run through `main(argv)` in a temporary directory, on a
    stub env registered for the test (the plain physics costs seconds per
    control step on a CPU) or, for convert, on the repo's checkpoint;
  * the device defaults to the GPU and raises without one.
"""

import shutil
from pathlib import Path
from typing import NamedTuple

import click
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from balance_robot_tpu import cli as jcli

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch import cli
from balance_robot_tpu_torch.device import resolve_device
from balance_robot_tpu_torch.train import checkpoint, factory

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
POLICY = ROOT / "models" / "Env01-v2_PPO" / "best_model.npz"


# ------------------------------------------------------------ the options

def _port_commands():
    parser = cli.build_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    return parser, sub.choices


def _port_options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings
            and a.dest != "help"}


def _click_default(p):
    """The default of a click parameter; an option without one (click 8.2+
    marks it with an UNSET sentinel) reads as None, as in argparse."""
    return None if p.default is getattr(click.core, "UNSET", None) \
        else p.default


def test_commands_options_and_defaults_match_the_jax_cli():
    parser, commands = _port_commands()
    assert set(commands) == set(jcli.cli.commands)
    for name, command in jcli.cli.commands.items():
        mine = _port_options(commands[name])
        theirs = {p.name: p for p in command.params if p.name != "physics"}
        assert set(mine) == set(theirs), name
        for key, p in theirs.items():
            assert mine[key].option_strings == p.opts, (name, key)
            assert mine[key].default == _click_default(p), (name, key)
            assert mine[key].required == p.required, (name, key)
            if p.is_flag:
                assert mine[key].const is True, (name, key)
    mine = _port_options(parser)
    theirs = {p.name: p for p in jcli.cli.params}
    for key in ("algorithm", "model"):
        assert mine[key].option_strings == theirs[key].opts
        assert mine[key].default == _click_default(theirs[key])
        assert mine[key].required == theirs[key].required
    # --platform tpu|cpu becomes --device cuda|cpu, both defaulting to the
    # accelerator
    assert theirs["platform"].default is None
    assert mine["device"].default is None
    assert mine["device"].choices == ["cuda", "cpu"]
    assert "physics" not in _port_options(commands["train"])


def test_names_match_the_jax_cli():
    assert cli.ALGORITHMS == jcli.ALGORITHMS == factory.KNOWN
    assert (cli.MODEL_DIR, cli.LOG_DIR, cli.MOVIE_DIR, cli.GRACE_STEPS) == (
        jcli.MODEL_DIR, jcli.LOG_DIR, jcli.MOVIE_DIR, jcli.GRACE_STEPS)


# ------------------------------------------------------ stub envs (float32)

def _obs(t, stack):
    """obs of control step t (a float32 array of either package): exact in
    float32 on both sides."""
    return stack([t * 0.25, -t * 0.5, 1.0 + t, 2.0 - t, t, t * 0.0])


class JState(NamedTuple):
    t: jnp.ndarray
    phys: NamedTuple


class JPhys(NamedTuple):
    qpos: tuple


class JaxStub:
    """A one-env stub of the JAX package's env surface."""

    def __init__(self, term_at):
        self.term_at = term_at

    def reset(self, key):
        t = jnp.int32(0)
        zero = jnp.float32(0.0)
        return JState(t, JPhys((zero, zero, zero))), _obs(zero, jnp.stack)

    def step(self, state, action):
        t = state.t + 1
        q = state.phys.qpos
        q = (q[0] + 0.125 * action[0], q[1] + 0.125 * action[1], q[2] + 1.0)
        r = jnp.float32(1.0) - 0.0625 * t.astype(jnp.float32) + action[0]
        term = (t == self.term_at) if self.term_at else jnp.bool_(False)
        obs = _obs(t.astype(jnp.float32), jnp.stack)
        return JState(t, JPhys(q)), obs, r, term, jnp.bool_(False)

    def telemetry(self, state):
        return (state.t.astype(jnp.float32) * 0.005, state.phys.qpos[0],
                state.phys.qpos[1])


class TState(NamedTuple):
    t: torch.Tensor
    phys: NamedTuple


class TPhys(NamedTuple):
    qpos: torch.Tensor


class Stub:
    """A batched stub of the port's env surface: the same arithmetic as
    JaxStub, and what the trainer and the evaluator read."""
    id = "Stub-v0"
    obs_dim = 6
    act_dim = 2
    max_episode_steps = 5
    term_at = None

    def __init__(self, device=None, dtype=torch.float32, seed=0):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def use_fast_solver(self):
        return self

    def reset(self, n):
        t = torch.zeros(n, dtype=torch.int32, device=self.device)
        obs = _obs(t.to(torch.float32), lambda xs: torch.stack(xs, 1))
        return TState(t, TPhys(torch.zeros(n, 3, dtype=self.dtype))), obs

    def step(self, state, action, uniforms=None):
        t = state.t + 1
        a = action.to(self.dtype)
        q = state.phys.qpos + torch.stack(
            [0.125 * a[:, 0], 0.125 * a[:, 1], torch.ones_like(a[:, 0])], 1)
        r = 1.0 - 0.0625 * t.to(self.dtype) + a[:, 0]
        term = t == self.term_at if self.term_at else torch.zeros_like(
            t, dtype=torch.bool)
        obs = _obs(t.to(torch.float32), lambda xs: torch.stack(xs, 1))
        return (TState(t, TPhys(q)), obs, r, term,
                t >= self.max_episode_steps)

    def telemetry(self, state):
        return (state.t.to(torch.float32) * 0.005, state.phys.qpos[:, 0],
                state.phys.qpos[:, 1])


def _act(obs):
    return np.array([0.5 - obs[0] * 0.015625, obs[1] * 0.03125], np.float32)


@pytest.mark.parametrize("term_at,max_steps,episodes", [
    (5, 6000, 2), (None, 3, 1)])
def test_run_episodes_prints_and_records_as_the_jax_cli(
        tmp_path, capsys, term_at, max_steps, episodes):
    """Grace steps after termination (or the loop's own end), one
    telemetry row per step, --show-io and --show-i every 30th step and the
    recorded qpos: the same lines and arrays from both packages."""
    port = Stub(device="cpu")
    port.term_at = term_at
    port.max_episode_steps = 10 ** 6
    outs = []
    for name, mod, env in (("port", cli, port),
                           ("jax", jcli, JaxStub(term_at))):
        record = tmp_path / f"{name}.npz"
        mod._run_episodes(env, _act, episodes, max_steps, show_io=True,
                          record=record, show_i=True)
        outs.append(capsys.readouterr().out.replace(str(record), "REC"))
    assert outs[0] == outs[1]
    lines = outs[0].splitlines()
    episodes_seen = [l for l in lines if l.startswith("episode ")]
    rows = [l for l in lines if l.count(",") == 2 and "[" not in l]
    steps = (term_at + cli.GRACE_STEPS + 1 if term_at
             else max_steps + cli.GRACE_STEPS + 1)
    assert len(episodes_seen) == episodes
    assert all(l.endswith(f"len={term_at or steps}") for l in episodes_seen)
    assert len(rows) == episodes * steps
    mine, theirs = (np.load(tmp_path / f"{n}.npz")["qpos"]
                    for n in ("port", "jax"))
    assert mine.shape == (episodes * steps, 3)
    np.testing.assert_array_equal(mine, theirs)


class Loopback:
    """A fake MCU: answers each obs line with [-obs[0], obs[1]]."""

    def __init__(self):
        self.sent = []

    def write(self, data):
        row = [float(x) for x in data.decode().strip().split(",")]
        self.sent.append(data)
        a = np.clip([-row[0], row[1]], -1, 1)
        self._resp = (",".join(f"{v:.4f}" for v in a) + "\r\n").encode()

    def readline(self):
        return self._resp


def test_serial_act_speaks_the_jax_protocol():
    obs = np.random.default_rng(0).uniform(-2, 2, (5, 6)).astype(np.float32)
    mine, theirs = Loopback(), Loopback()
    act, ref = cli._serial_act(mine), jcli._serial_act(theirs)
    for o in obs:
        a, b = act(o), ref(o)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert mine.sent == theirs.sent


# ------------------------------------------------------- main(argv) runs

@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory holding a copy of the Env01-v2 policy under
    ck/, with Stub-v0 registered."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(brt._REGISTRY, "Stub-v0", Stub)
    (tmp_path / "ck").mkdir()
    shutil.copy(POLICY, tmp_path / "ck" / "best_model.npz")
    return tmp_path


def test_the_device_defaults_to_the_gpu(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-a", "PPO", "test", "-e", "Env01-v2"])
    assert not (workdir / "models").exists()
    with pytest.raises(SystemExit):
        cli.main(["-a", "PPO", "--device", "gpu", "test", "-e", "Env01-v2"])
    with pytest.raises(SystemExit, match="not available"):
        cli.main(["-a", "TRPO", "--device", "cpu", "test", "-e", "Stub-v0"])


def test_convert_then_test_onnx(workdir, capsys):
    """convert writes the committed .onnx bytes, a SavedModel where
    TensorFlow imports, and the .brq; test-onnx then runs it on the native
    executor."""
    base = ["-a", "PPO", "-m", "ck/best_model", "--device", "cpu"]
    try:
        import tensorflow  # noqa: F401
        cli.main(base + ["convert", "-e", "Env01-v2"])
    except ImportError:
        with pytest.raises(ImportError):
            cli.main(base + ["convert", "-e", "Env01-v2"])
    assert (workdir / "ck" / "best_model.onnx").read_bytes() == (
        POLICY.parent / "best_model.onnx").read_bytes()
    out = capsys.readouterr().out
    assert "wrote ck/best_model.onnx" in out
    if (workdir / "ck" / "saved_model").exists():
        assert (workdir / "ck" / "best_model_int8.brq.npz").exists()
    assert {p.name for p in workdir.iterdir()} >= {"models", "logs",
                                                  "movies"}
    cli.main(base + ["test-onnx", "-e", "Stub-v0", "--show-io"])
    out = capsys.readouterr().out.splitlines()
    assert [l for l in out if l.startswith("episode")] == [
        l for l in out if l.startswith("episode 0:")]
    assert [l for l in out if l.startswith("episode")][0].endswith(
        f"len={Stub.max_episode_steps}")
    assert sum(l.count(",") == 2 for l in out) == (
        Stub.max_episode_steps + cli.GRACE_STEPS + 1)
    with pytest.raises(SystemExit, match="run `convert` first"):
        cli.main(["-a", "PPO", "--device", "cpu", "test-onnx", "-e",
                  "Stub-v0"])


def test_test_command_on_a_stub(workdir, capsys):
    cli.main(["-a", "PPO", "-m", "ck/best_model", "--device", "cpu", "test",
              "-e", "Stub-v0", "--episodes", "2", "--record", "r.npz"])
    out = capsys.readouterr().out.splitlines()
    assert sum(l.startswith("episode ") for l in out) == 2
    assert np.load(workdir / "r.npz")["qpos"].shape == (
        2 * (Stub.max_episode_steps + cli.GRACE_STEPS + 1), 3)


def test_train_and_bc_init_on_a_stub(workdir, capsys):
    """train -a PPO / A2C / SAC for two iterations with an eval after each
    (the runner's artifacts under models/ and logs/ of the working
    directory; SAC at the CLI's 1e6-row buffer, its second iteration past
    learning_starts, so it updates once, and no recordings); bc-init at its
    defaults saves a warm start that PPO loads."""
    base = ["-a", "PPO", "--device", "cpu", "train", "-e", "Stub-v0",
            "--num-envs", "8", "--rollout-steps", "4", "--minibatch", "8",
            "--epochs", "2", "--total-timesteps", "64", "--eval-freq", "32",
            "--record-every", "1"]
    cli.main(base)
    run = workdir / "models" / "Stub-v0_PPO"
    for f in ("best_model", "longest_model", "final_model", "resume_state"):
        assert (run / f"{f}.npz").exists(), f
    assert (workdir / "logs" / "Stub-v0_PPO.csv").read_text().count(
        "\n") == 3
    assert len(list((workdir / "movies").iterdir())) == 2
    base[1] = "A2C"
    cli.main(base[:9] + ["--total-timesteps", "80", "--eval-freq", "40"])
    assert (workdir / "models" / "Stub-v0_A2C" / "final_model.npz").exists()
    base[1] = "SAC"
    cli.main(base[:7] + ["--num-envs", "64", "--total-timesteps", "128",
                         "--eval-freq", "64", "--record-every", "1"])
    run = workdir / "models" / "Stub-v0_SAC"
    params = checkpoint.load(run / "final_model")
    committed = checkpoint.load(ROOT / "models" / "Env01-v2_SAC" /
                                "best_model")
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in committed.items()}
    for f in ("best_model", "longest_model", "resume_state"):
        assert (run / f"{f}.npz").exists(), f
    rows = (workdir / "logs" / "Stub-v0_SAC.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[1].split(",")[5] == "nan", rows
    assert np.isfinite(float(rows[2].split(",")[5])), rows
    assert len(list((workdir / "movies").iterdir())) == 2

    cli.main(["-a", "PPO", "--device", "cpu", "bc-init", "-e", "Stub-v0",
              "--out", "bc.npz", "--log-std", "-0.5"])
    out = capsys.readouterr().out
    assert "bc step 0:" in out and "bc step 1999:" in out
    assert "saved bc.npz — train with -m bc.npz" in out
    params = checkpoint.load(workdir / "bc.npz")
    np.testing.assert_array_equal(params["log_std"], [-0.5, -0.5])
    cli.main(["-a", "PPO", "-m", "bc.npz"] + base[2:])
    assert "warm start from bc.npz" in capsys.readouterr().out
