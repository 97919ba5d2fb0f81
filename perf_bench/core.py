"""What every cell shares: finding its files by name, the guards, the card.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. The
harness finds by those names, and by nothing else:

  configs/<config>.json     the env id, policy file, solver grade, dtype,
                            the kernel's launch (for `work/count_work.py`);
  workloads/<cell>.json     the timed loop's name, the traffic's parameters and
                            the limits of the numbers that decide `correct`;
  drivers/<driver>.py       the timed loop (`setup`, `window`, `compare`);
  metrics/<metric>.py       one reader per per-layer metric (`read`);
  grades/<grade>.json       a solver grade's settings, for the port and the
                            reference alike;
  reference/envs/<env>.py   the plain reference of an env id's step;
  work/<cell>.json          the frozen work of one env-step of the cell;
  work/peak.json            the card's published peak.
"""

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# no run may hold these, compared by whole top-level module name: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "balance_robot_tpu")


def forbidden_modules(names=None):
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Refused(Exception):
    """A run that must end without a result (exit code 2)."""


def require_no_forbidden(when):
    found = forbidden_modules()
    if found:
        raise Refused(f"{when}: forbidden modules are loaded: "
                      f"{', '.join(found)}")


def load_json(path):
    return json.loads(Path(path).read_text())


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name, bench=None):
    """(workload entry of BENCHMARK.json, its traffic file, the config
    entry, its config file) of the cell `name`."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json: "
                      f"{sorted(cells)}")
    entry = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    traffic = load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    return entry, traffic, config, load_json(ROOT / config["file"])


def driver(name):
    """The module drivers/<name>.py."""
    return importlib.import_module(f"perf_bench.drivers.{name}")


def metric_reader(name):
    """The module metrics/<name>.py, or None where there is none."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(
        "perf_bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def grade_name(traffic, config):
    """The solver grade a cell runs: its traffic's, else its config's."""
    return traffic.get("grade") or config["grade"]


def solver(grade):
    """The settings of solver grade `grade` (grades/<grade>.json) that the
    grade changes in a scene: empty for the registered grade."""
    path = HERE / "grades" / f"{grade}.json"
    if not path.exists():
        raise KeyError(f"no solver grade {grade!r} ({path.name})")
    return {k: v for k, v in load_json(path).items() if k != "why"}


def work_of(cell_name):
    """The frozen work of `cell_name` (work/<cell>.json) or None."""
    path = HERE / "work" / f"{cell_name}.json"
    return load_json(path) if path.exists() else None


def peak():
    return load_json(HERE / "work" / "peak.json")


def metrics_of_cell(bench, cell_name, section):
    """The entries of `section` ("end_to_end" or "per_layer") that this
    cell reports: those with no `workloads` key, or that list it."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def card(n_needed):
    """The card's facts for the result, after checking that CUDA has at
    least `n_needed` devices; raises Refused otherwise (no CPU fallback)."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark runs only on the card")
    count = torch.cuda.device_count()
    if count < n_needed:
        raise Refused(f"{count} CUDA devices, the cell needs {n_needed}")
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=n_needed)


def smi():
    """nvidia-smi's reading of the card: name, clocks, power draw and
    limit (a dict of strings; empty where nvidia-smi cannot be run)."""
    fields = ("name", "clocks.sm", "clocks.max.sm", "power.draw",
              "power.limit", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    line = out.stdout.strip().splitlines()[:1]
    if out.returncode or not line:
        return {}
    return dict(zip(fields, (v.strip() for v in line[0].split(","))))
