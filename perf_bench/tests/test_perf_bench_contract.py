"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import re

import pytest

from perf_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = core.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perf_bench/run.py"]
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in BENCH["per_layer"]:
        assert one_line(m["layer"])
    names += CELLS + [m["name"] for s in ("end_to_end", "per_layer")
                      for m in BENCH[s]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"env_steps_per_s", "step_ms_p95", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry, traffic, config_entry, config = core.cell(cell, BENCH)
    assert (core.ROOT / config_entry["file"]).exists()
    assert (core.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    driver = core.driver(traffic["driver"])
    assert all(callable(getattr(driver, f))
               for f in ("setup", "window", "compare"))
    assert (core.ROOT / config["policy"]).exists()
    assert core.work_of(cell) is not None
    assert traffic["limits"], "every cell's numbers need limits"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in core.metrics_of_cell(BENCH, cell,
                                                    "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = core.metrics_of_cell(BENCH, cell, "per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    reader = core.metric_reader(metric)
    assert reader is not None and callable(reader.read)
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert set(m["workloads"]) <= set(CELLS)


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(",")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
