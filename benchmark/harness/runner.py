"""One run of one cell: set-up, the measured window, the profiled stretch,
the check against the reference, and the result line."""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import compare, trace as trace_mod, work as work_mod
from benchmark.harness.manifest import Cell

# top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pwclonet_pylidarslam_tpu")


@dataclass
class Window:
    elapsed_s: float = 0.0
    calls: int = 0
    units: int = 0  # samples or frames completed
    work_units: int = 0  # samples or pairs the network processed
    call_s: List[float] = field(default_factory=list)
    failed: int = 0


@dataclass
class Record:
    """What a metric's reader reads."""

    setup_s: float
    window: Window
    counters: Dict[str, float]
    work: work_mod.Work  # of one work unit (a sample or a pair)
    train: bool
    batch: int
    stretch: Optional[trace_mod.Stretch] = None


class NoDevice(RuntimeError):
    """The run asks for more cards than the machine has."""


def require_cards(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, the machine has "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, seconds: float, device: torch.device) -> Window:
    """Call the timed path one call after another for ``seconds``; every call
    ends on a read-back, so the window ends on one."""
    w = Window()
    driver.reset_counters()
    _sync(device)
    t0 = time.perf_counter()
    while w.elapsed_s < seconds:
        c0 = time.perf_counter()
        done = driver.call()
        now = time.perf_counter()
        w.call_s.append(now - c0)
        w.calls += 1
        w.units += done.units
        w.work_units += done.work_units
        w.failed += int(not done.ok)
        w.elapsed_s = now - t0
    return w


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> Dict:
    """Run the cell once; returns the result object (``correct`` and all)."""
    t_setup = time.perf_counter()
    driver = cell.driver.Driver(cell.config, cell.workload, seed, device)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    stages = getattr(driver, "phases", None)
    phases = {"start": t_setup - t_start, **(stages.seconds if stages else {})}
    print("set-up phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)
    window = measure(driver, seconds, device)
    stretch = None
    t0 = time.perf_counter()
    if trace:
        stretch = trace_mod.profile(driver.stretch, device)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = dict(driver.counters)
    driver.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.readings()
    t2 = time.perf_counter()
    print(f"setup {setup_s:.3f} s, window {window.elapsed_s:.3f} s ({window.calls} calls), "
          f"stretch {t1 - t0:.3f} s, check {t2 - t1:.3f} s", file=sys.stderr)
    limits = cell.workload["limits"]
    correct = compare.judge(readings, limits)
    record = Record(setup_s=setup_s, window=window, counters=counters,
                    work=work_mod.work_of(cell.config, 1, driver.train, driver.fused),
                    train=driver.train, batch=driver.batch, stretch=stretch)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_modules[m["name"]].read(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window.calls, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        result["breakdown"] = {"device_ops": stretch.top_ops(), "idle_gaps": stretch.top_idle()}
    # a reading that is not finite (a missing or broken answer) prints as text
    result["checks"] = {k: {"value": _number(readings.get(k, float("nan"))), "limit": v}
                        for k, v in limits.items()}
    return result


def emit(result: Dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=_plain))
    sys.stdout.flush()


def _number(x: float):
    return float(x) if math.isfinite(x) else str(x)


def _plain(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    raise TypeError(type(x))
