"""The port's spans and counters (`utils/profiling.py`) on the CPU: what
they record with and without a profiler, where the CLI's B = 1 loop and the
evaluator put them, and that they change no output.

The physics of Env01-v2 is a cheap fake here (`fake_step`): under a CPU
profiler the plain 250-substep step would record every op of every
substep. It keeps the chassis upright, or tips the rows asked for past
the termination pitch, and moves the wheels by the control, so the
policy's actions reach the outputs compared.
"""

import io
import json
import math
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch import cli
from balance_robot_tpu_torch.envs import env01
from balance_robot_tpu_torch.physics import cuda_step, kernel_build
from balance_robot_tpu_torch.train import checkpoint
from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
from balance_robot_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
POLICY = ROOT / "models" / "Env01-v2_PPO" / "best_model.npz"
TIPPED = (math.cos(0.6), math.sin(0.6), 0.0, 0.0)   # pitch 1.2 rad > 50 deg


def fake_step(tip_rows=()):
    def step(qpos, qvel, ws, ctrl, friction, params, frame_skip=250):
        qp, qv = qpos.clone(), qvel.clone()
        qp[:, 3:7] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=qp.dtype)
        for i in tip_rows:
            qp[i, 3:7] = torch.tensor(TIPPED, dtype=qp.dtype)
        qp[:, 7:9] += 0.01 * ctrl
        qv[:, 6:8] = ctrl
        return qp, qv, ws
    return step


def profiled(fn):
    """fn() under a CPU `torch.profiler`; (its result, the profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def step_of(spans):
    """The index of each span's enclosing `cli.step` (its own where it is
    one), or None."""
    out = []
    for name, parent, _, _ in spans:
        out.append(len(out) if name == "cli.step"
                   else None if parent is None else out[parent])
    return out


@pytest.fixture
def store():
    profiling.clear()
    yield profiling
    profiling.clear()


def test_a_span_without_a_profiler_records_nothing(store, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with store.span("cli.step"):
        with store.span("cli.sync.obs"):
            torch.ones(2).sum()
    assert store.spans() == []
    with store.setup_span("setup.thing"):
        pass
    (name, parent, t0, t1), = store.spans()
    assert (name, parent) == ("setup.thing", None) and t0 <= t1


def test_nested_spans_in_the_store_and_in_the_chrome_trace(store, tmp_path):
    def work():
        with store.span("outer"):
            with store.span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with store.setup_span("once"):
                pass
    _, prof = profiled(work)
    spans = store.spans()
    assert [(n, p) for n, p, _, _ in spans] == [
        ("outer", None), ("inner", 0), ("once", 0)]
    (_, _, a0, a1), (_, _, b0, b1), (_, _, c0, c1) = spans
    assert a0 <= b0 <= b1 <= c0 <= c1 <= a1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_a_span_cut_by_the_profilers_stop_stays_open(store):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with store.span("cut"):
        with store.span("whole"):
            pass
        prof.stop()
    assert [(n, p, t1 is None) for n, p, _, t1 in store.spans()] == [
        ("cut", None, True), ("whole", 0, False)]


def test_counters_and_clear(store):
    store.count("a")
    store.count("a", 4)
    store.count("b", 0)
    assert store.counters() == {"a": 5, "b": 0}
    store.clear()
    assert store.counters() == {} and store.spans() == []


def test_the_kernels_load_and_first_launch_are_set_up_spans(store,
                                                            monkeypatch):
    monkeypatch.setattr(cuda_step.KERNEL, "lib", None)
    monkeypatch.setattr(kernel_build, "build", lambda *a: "lib.so")
    monkeypatch.setattr(cuda_step.KERNEL, "bind",
                        lambda path: f"bound {path}")
    assert cuda_step.KERNEL.build() == "bound lib.so"
    assert cuda_step.KERNEL.build() == "bound lib.so"
    entry = "test_entry_of_no_kernel"
    for _ in range(3):
        with kernel_build.first_launch(entry):
            pass
    assert [s[0] for s in store.spans()] == ["kernel.load",
                                             "kernel.first_launch"]


def run_loop(monkeypatch, tip_rows, trace, record):
    """`cli._run_episodes` on Env01-v2 at B = 1 with `_policy_act`, one
    episode of at most 2 steps and 1 grace step: (printed lines, the
    recorded trajectory)."""
    monkeypatch.setattr(env01, "control_step", fake_step(tip_rows))
    monkeypatch.setattr(cli, "GRACE_STEPS", 1)
    env = brt.make("Env01-v2", device="cpu", seed=3)
    act = cli._policy_act(checkpoint.load(str(POLICY)), env)
    out = io.StringIO()

    def loop():
        with redirect_stdout(out):
            cli._run_episodes(env, act, 1, 2, show_io=True, record=record)
    if trace:
        profiled(loop)
    else:
        loop()
    lines = [x for x in out.getvalue().splitlines()
             if not x.startswith("trajectory recorded")]
    return lines, np.load(record)["qpos"]


@pytest.mark.parametrize("tip_rows,syncs", [
    ((), [7, 7, 7, 7]),     # no end: 2 steps + 1 grace + 1, trunc read
    ((0,), [6, 4, 4]),      # ends at once: term is read, trunc is not
])
def test_run_episodes_steps_and_their_syncs(store, monkeypatch, tmp_path,
                                            tip_rows, syncs):
    run_loop(monkeypatch, tip_rows, True, tmp_path / "on.npz")
    spans = store.spans()
    owner = step_of(spans)
    steps = [i for i, s in enumerate(spans) if s[0] == "cli.step"]
    assert all(spans[i][3] is not None for i in steps)
    per_step = [[s[0] for j, s in enumerate(spans)
                 if owner[j] == i and s[0].startswith("cli.sync.")]
                for i in steps]
    assert [len(x) for x in per_step] == syncs
    assert per_step[0][:4] == ["cli.sync.obs", "cli.sync.policy_in",
                               "cli.sync.policy_out", "cli.sync.action"]
    assert per_step[0][4:] == (["cli.sync.reward", "cli.sync.term",
                                "cli.sync.trunc"] if not tip_rows else
                               ["cli.sync.reward", "cli.sync.term"])
    for parent, children in (("cli.act", ("policy_in", "policy_out")),
                             ("cli.done", ("reward", "term", "trunc"))):
        parents = {j for j, s in enumerate(spans) if s[0] == parent}
        assert {s[1] for s in spans
                if s[0] in [f"cli.sync.{c}" for c in children]} <= parents
    assert sum(s[0] == "cli.done" for s in spans) == (1 if tip_rows else 4)
    assert sum(s[0] == "cli.env_step" for s in spans) == len(steps)


@pytest.mark.parametrize("tip_rows", [(), (0,)])
def test_run_episodes_outputs_are_the_same_traced(store, monkeypatch,
                                                  tmp_path, tip_rows):
    off = run_loop(monkeypatch, tip_rows, False, tmp_path / "off.npz")
    assert store.spans() == []
    on = run_loop(monkeypatch, tip_rows, True, tmp_path / "on.npz")
    assert store.spans()
    assert off[0] == on[0] and any("episode 0" in x for x in off[0])
    assert off[1].tobytes() == on[1].tobytes() and len(off[1])


def evaluate(monkeypatch, tip_rows, trace, max_steps=5, chunk=2, n=3):
    monkeypatch.setattr(env01, "control_step", fake_step(tip_rows))
    env = brt.make("Env01-v2", device="cpu", seed=5)
    states, obs = env.reset(n)
    qpos = states.phys.qpos.clone()
    qpos[:, 3:7] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=qpos.dtype)
    states = states._replace(phys=states.phys._replace(qpos=qpos))
    act = cli._policy_act(checkpoint.load(str(POLICY)), env)

    def act_fn(_, o):
        return torch.as_tensor(np.stack([act(x) for x in o.numpy()]))
    ev = ChunkedEvaluator(env, act_fn, chunk)

    def run():
        return ev.evaluate_detail(None, n, max_steps,
                                  start=(states, obs))
    return profiled(run)[0] if trace else run()


@pytest.mark.parametrize("tip_rows,stepped", [
    ((0,), 3 * 5),          # episode 0 ends at once, the rest run to 5
    ((0, 1, 2), 3 * 2),     # all end at once: the first chunk of 2 only
])
def test_evaluate_detail_counts_live_and_stepped_env_steps(
        store, monkeypatch, tip_rows, stepped):
    rets, lens = evaluate(monkeypatch, tip_rows, False)
    assert lens.tolist() == [1 if i in tip_rows else 5 for i in range(3)]
    assert store.counters() == {"eval.live_env_steps": int(lens.sum()),
                                "eval.stepped_env_steps": stepped}
    evaluate(monkeypatch, tip_rows, False)
    assert store.counters()["eval.stepped_env_steps"] == 2 * stepped


@pytest.mark.parametrize("tip_rows", [(0,), (0, 1, 2)])
def test_evaluate_detail_outputs_are_the_same_traced(store, monkeypatch,
                                                     tip_rows):
    off = evaluate(monkeypatch, tip_rows, False)
    on = evaluate(monkeypatch, tip_rows, True)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_the_package_import_is_one_set_up_span():
    code = ("import balance_robot_tpu_torch, importlib; "
            "import balance_robot_tpu_torch.cli; "
            "from balance_robot_tpu_torch.utils import profiling as p; "
            "s = [x for x in p.spans() if x[0] == 'setup.import']; "
            "print(len(s), s[0][1], s[0][2] < s[0][3])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "None", "True"]
