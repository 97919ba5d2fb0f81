"""The cells `env03v1.rollout` and `env01v2.rollout_256` on the CPU at a
tiny size: a sound run comes out correct; the control and each fault of
`faults_env03v1.py` do not, the latter on the numbers it names. The
readers of the new per-layer metrics (`k2.coupled_share`,
`env03.host_ms_per_step`, `env03.launch_rate`) on made-up stores, and the
cells' listed metrics on their frozen work.

At a tiny size a block first parks after ~55 steps, so the Env03-v1 runs
start every block where the sampled step acts on it: in rows 0 and 1
parked (fired in the first step), in rows 2 and 3 falling onto the
chassis's top face (in reach, struck in the first step)."""

import pytest
import torch

from balance_robot_tpu_torch.envs import env03
from perf_bench import core, faults_env03v1, run, spans
from perf_bench.drivers import rollout_block

BLOCK = "env03v1.rollout"
K1_TEAM = "env01v2.rollout_256"
TINY = {BLOCK: dict(n_envs=4, warmup_steps=0, sampled_steps=2),
        K1_TEAM: dict(n_envs=4, warmup_steps=1, sampled_steps=2)}
SEED = 3000000233
MS = 1_000_000


def block_at_work(monkeypatch):
    """Env03-v1's reset with rows 0, 1 parked and rows 2, 3 falling at 1
    m/s onto the top face of the upright chassis (0.185 m above the robot's
    origin), 1 mm above it."""
    reset = env03.Env03V1.reset

    def at_work(self, n):
        state, obs = reset(self, n)
        qpos, qvel = state.phys.qpos.clone(), state.phys.qvel.clone()
        started = state.aux["delay_started"].clone()
        started[0:2] = True
        qpos[0:2, 9:12] = torch.tensor(env03.PARK_POS, dtype=qpos.dtype)
        qvel[0:2, 8:11] = 0.0
        qpos[2:4, 9:12] = qpos[2:4, 0:3] + torch.tensor(
            (0.0, 0.0, 0.185 + 0.021), dtype=qpos.dtype)
        qvel[2:4, 8:11] = torch.tensor((0.0, 0.0, -1.0), dtype=qvel.dtype)
        return state._replace(
            phys=state.phys._replace(qpos=qpos, qvel=qvel),
            aux={**state.aux, "delay_started": started}), obs
    monkeypatch.setattr(env03.Env03V1, "reset", at_work)


def cpu_run(cell, control=False):
    return run.run(["--workload", cell, "--seed", str(SEED), "--seconds",
                    "0.1"], device="cpu", overrides=TINY[cell],
                   control=control)


def failed(result):
    return sorted(name for name, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.fixture
def at_work(monkeypatch):
    block_at_work(monkeypatch)


def test_the_sampled_step_fires_and_strikes(at_work, capsys):
    result = cpu_run(BLOCK)
    assert result["correct"], failed(result)
    assert {"launch", "near_p90"} <= set(result["checks"])
    err = capsys.readouterr().err
    assert "sampled step 0: 2 of 4 envs fire, 2 within reach" in err


@pytest.mark.parametrize("cell", [K1_TEAM, BLOCK])
def test_a_sound_run_is_correct(cell):
    result = cpu_run(cell)
    assert result["correct"], failed(result)
    assert result["attempted"] >= TINY[cell]["n_envs"]


@pytest.mark.parametrize("cell", [K1_TEAM, BLOCK])
def test_the_control_fails_a_limit(cell, monkeypatch):
    if cell == BLOCK:
        block_at_work(monkeypatch)
    result = cpu_run(cell, control=True)
    assert not result["correct"]
    assert failed(result)


@pytest.mark.parametrize("fault,fails", faults_env03v1.FAULTS,
                         ids=[f.__name__ for f, _ in faults_env03v1.FAULTS])
def test_a_fault_fails_the_numbers_it_names(fault, fails, at_work,
                                            monkeypatch):
    fault(monkeypatch.setattr)
    result = cpu_run(BLOCK)
    assert not result["correct"]
    # the numbers named are those the fault fails however few envs it
    # moves; where it moves many (4 envs here, or at 1,024 a block held
    # back for 0.5 s, or the ~2 / 3 of the envs whose block is in reach)
    # the 90th percentiles over all envs fail too
    assert fails <= set(failed(result)), result["checks"]


def test_reach_covers_the_robot_and_a_step_of_flight():
    # the chassis box's far corner 0.1925 m, the block's half-diagonal
    # 0.0346 m and margin 0.002 m, 5 m/s x 5 ms
    assert rollout_block.REACH == pytest.approx(
        (0.05 ** 2 + 0.0185 ** 2 + 0.185 ** 2) ** 0.5 + 0.02 * 3 ** 0.5
        + 0.002 + 0.025)
    qpos = torch.zeros((3, 16))
    qpos[:, 9:12] = torch.tensor([[0.0, 0.0, 0.25], [0.0, 0.3, 0.15],
                                  list(env03.PARK_POS)])
    assert rollout_block.within_reach(qpos).tolist() == [True, False, False]


# K2's counters over 2 timed launches of 4 envs, 3 of whose Newton steps
# took the coupled factorization
COUNTERS = {"k2.coupled_steps": 3, "k2.envs": 4, "k2.timed_launches": 2,
            "env03.block_launches": 30, "env03.env_steps": 1024}
STORE = [("env03.step", None, 0, 20 * MS),
         ("env03.events", 0, 15 * MS, 16 * MS),
         ("cli.step", None, 25 * MS, 90 * MS),
         ("env03.step", None, 100 * MS, 130 * MS),
         ("env03.step", None, 140 * MS, None)]
EXPECTED = {"k2.coupled_share": 100.0 * 3 / (4 * 2 * 250 * 4),
            "env03.host_ms_per_step": 25.0,
            "env03.launch_rate": 30 / 1024}


def data_of(cell, kernel_s=0.025, rate=40000.0):
    """A traced run's data: three launches of the cell's kernel, back to
    back 1 ms apart, at `rate` env-steps per second."""
    _, traffic, _, config = core.cell(cell)
    work = core.work_of(cell)
    trace = dict(device_ops=[(work["kernel_name"], i * (kernel_s + 0.001),
                              kernel_s) for i in range(3)],
                 start_s=0.0, window_s=3 * (kernel_s + 0.001),
                 busy_s=3 * kernel_s)
    return dict(trace=trace, work=work, peak=core.peak(),
                e2e={"env_steps_per_s": rate}, config=config,
                traffic=traffic,
                window=dict(seconds=1.0, steps=3, traced_steps=3))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_new_reader_on_a_made_up_store(name, monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: (STORE, dict(COUNTERS)))
    assert core.metric_reader(name).read(data_of(BLOCK)) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_new_reader_reads_nothing_without_a_store(name, monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: None)
    assert core.metric_reader(name).read(data_of(BLOCK)) is None
    monkeypatch.setattr(spans, "store", lambda: ([], {}))
    assert core.metric_reader(name).read(data_of(BLOCK)) is None


def test_the_coupled_share_needs_the_grades_newton_iterations(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: (STORE, dict(COUNTERS)))
    d = data_of(BLOCK)
    d["traffic"] = dict(d["traffic"], grade="exact")
    assert core.metric_reader("k2.coupled_share").read(d) is None


@pytest.mark.parametrize("cell,kernel", [(BLOCK, "K2"), (K1_TEAM, "K1")])
def test_the_cells_frozen_work(cell, kernel):
    work = core.work_of(cell)
    _, traffic, _, _ = core.cell(cell)
    assert work["kernel"] == kernel and work["grade"] == "fast"
    assert work["batch"] == traffic["n_envs"]
    assert work["kernel_ops_min"] <= work["kernel_ops_per_env"] \
        <= work["kernel_ops_max"]
    assert work["policy_flops_per_env_step"] == 2 * (6 * 64 + 64 * 64
                                                     + 64 * 2)


@pytest.mark.parametrize("cell", [BLOCK, K1_TEAM])
def test_the_listed_metrics_read_and_fail_when_the_kernel_is_renamed(
        cell, monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: (STORE, {
        **COUNTERS, **{f"k2.cycles.{s}": 10 for s in (
            "smooth", "contacts", "hessian", "factor", "linesearch",
            "update")}, "k2.cycles.slowest_env": 20}))
    bench = core.benchmark()
    listed = {m["name"] for m in core.metrics_of_cell(bench, cell,
                                                      "per_layer")}
    d = data_of(cell)
    got = run.per_layer(bench, cell, d)
    assert set(got) == listed
    for name in ("k1.roofline", "k2.roofline", "mfu.rollout"):
        if name in got:
            assert 0.0 < got[name]["value"] < 100.0
    d["trace"]["device_ops"] = [("renamed_kernel", 0.0, 0.025)] * 3
    with pytest.raises(run.MissingMetric, match="found nothing"):
        run.per_layer(bench, cell, d)
