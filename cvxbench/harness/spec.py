"""BENCHMARK.json, and the files each cell, traffic mix and metric has.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by its name:

- a configuration: the `file` its `configs` entry names (under configs/);
- a traffic mix: `traffic/<traffic>.json`, parameters that the one
  generator (`generator.py`) reads;
- a cell's limits for the comparison that decides `correct`:
  `limits/<workload>.json`;
- a metric, end to end or per layer: `metrics/<name>.py`, a module with
  `read(run) -> float | None`.

So a later change adds a cell, a mix or a metric as new files and new
entries in BENCHMARK.json, and edits no file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "cvxbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One entry of `workloads`, with what its names resolve to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = ROOT


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench, workload, root=ROOT):
    """The cell named `workload`: its configuration, traffic and limits read
    from their files, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root)) as f:
        traffic = json.load(f)
    with open(limits_path(workload, root)) as f:
        limits = json.load(f)
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=Path(root),
    )


def traffic_path(name, root=ROOT):
    return Path(root) / "cvxbench" / "traffic" / f"{name}.json"


def limits_path(workload, root=ROOT):
    return Path(root) / "cvxbench" / "limits" / f"{workload}.json"


def metric_path(name, root=ROOT):
    return Path(root) / "cvxbench" / "metrics" / f"{name}.py"


def load_metric(name, root=ROOT):
    """The reader module of metric `name` (its file name may hold dots, so
    it is loaded by path)."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "cvxbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path} has no read(run)")
    return mod
