"""Cells cut to a size a CPU test run can hold: the benchmark's own
configurations and workloads with the point counts, sensors and windows
made small. Widths stay as the configurations give them."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import manifest  # noqa: E402

SEED = 2 ** 31 + 12345


def shrink_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    if c["model"] == "pwclonet":
        c.update(num_points=256, sa_npoints=[64, 32, 16, 8], sa_nsamples=[8, 8, 8, 4])
        c["input"].update(num_beams=8, num_cols=90)
    else:
        c["num_points"] = 256
        for st, n in zip(c["stages"], (64, 32, 16, 8)):
            st.update(npoint=n, nsample=8)
    return c


def shrink_workload(workload: dict) -> dict:
    w = copy.deepcopy(workload)
    if "frames" in w:
        w.update(frames=12, chunk=4, stretch_calls=2, checked_calls=2, reference_block=4)
    if "frames_per_drive" in w:
        w.update(frames_per_drive=6, batch=2, steps_per_dispatch=2)
    if "blocks" in w:
        w.update(blocks=8, batch=2, steps_per_dispatch=2)
    return w


def tiny_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = ROOT / "benchmark") -> manifest.Cell:
    cell = manifest.load_cell(manifest_path, name, bench_dir)
    cell.config = shrink_config(cell.config)
    cell.workload = shrink_workload(cell.workload)
    return cell
