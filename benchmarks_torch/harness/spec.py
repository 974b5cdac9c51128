"""A cell as the files name it: the entry of ``BENCHMARK.json``, its
configuration file and its workload file, and the per-layer metric readers
that list it; the modules of drivers, problems and metrics.  Everything is
found by name; nothing here knows a cell."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list = field(default_factory=list)


def _read_json(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_cell(name, bench_file=None):
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = _read_json(bench_file or ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}

    def listed(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=int(entry["chips"]),
                config=_read_json(ROOT / configs[entry["config"]]["file"]),
                workload=_read_json(BENCH_DIR / "workloads" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if listed(m)],
                per_layer=[m for m in bench["per_layer"] if listed(m)])


@functools.lru_cache(maxsize=None)
def load_module(kind, name):
    """``benchmarks_torch/<kind>/<name>.py`` as a module, loaded once (a
    metric's name may hold dots, so the file is loaded by path)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind}/{name}.py under {BENCH_DIR}")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_problem(cfg):
    """``problems/<cfg["problem"]>.py``: the configuration's program-side
    set-up, seeded initial fields, reference and guards."""
    return load_module("problems", cfg["problem"])
