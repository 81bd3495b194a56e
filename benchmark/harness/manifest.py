"""Find a cell's files by name: its workload, its configuration, its driver
and its metrics. A new cell, configuration, traffic mix or metric is a new
file here and an entry in ``BENCHMARK.json``; nothing else changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    entry: Dict  # the workload's entry in BENCHMARK.json
    workload: Dict  # workloads/<name>.json
    config: Dict  # the configuration's file
    driver: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]
    metric_modules: Dict[str, ModuleType]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """A metric applies to the cells its ``workloads`` lists; without the
    key, an end-to-end metric to every cell and a per-layer metric to every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(manifest_path: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    manifest = read_json(manifest_path)
    root = manifest_path.parent
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    workload = read_json(bench_dir / "workloads" / f"{name}.json")
    config = read_json(root / cfg_entry["file"])
    driver = load_module(bench_dir / "drivers" / f"{workload['driver']}.py",
                         f"bench_driver_{workload['driver']}")
    e2e = [m for m in manifest["end_to_end"] if applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if applies(m, name, names)]
    modules = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      "bench_metric_" + m["name"].replace(".", "_"))
               for m in e2e + per_layer}
    return Cell(name, entry, workload, config, driver, e2e, per_layer, modules)
