"""Batched ICP steps against single ones from the same state, under nudges.

Over the 11 KITTI-profile worlds of ``chip_smoke.py`` phase 13
(``kitti_preset(32, seed=s, num_points=8192)``, cast on the card), the
batched chain is stepped frame by frame. At every frame, each sequence's
batched step is compared with ``process_frame`` from its own slice of the
same state, and that single step with itself on the frame's scan moved by
one and two float32 ulp up and down, with a rerun of each (determinism).
Writes one JSON line a step and association mode to ``--out`` and prints a
summary a mode: how many steps differ by more than 1e-5 m while no nudge
moves the single step by as much, and how that splits by whether the
single step's Gauss-Newton loop converged before its iteration cap::

    python3 tools/batched_step_nudges.py --out chiprun_out/step_nudges.jsonl

Needs a CUDA card; takes about 3 minutes on an H100.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from pwclonet_pylidarslam_torch.slam import icp_odometry as icp  # noqa: E402

ATOL_M = 1e-5
NUDGES = {"up1": (np.inf, 1), "down1": (-np.inf, 1), "up2": (np.inf, 2), "down2": (-np.inf, 2)}


def frame_major(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2, 3))).cuda()


def nudged(scans: np.ndarray, direction: float, k: int) -> np.ndarray:
    for _ in range(k):
        scans = cs.nudge_ulp(scans, direction)
    return scans


def mode_rows(mode: str, scans: np.ndarray) -> list:
    cfg = icp.BatchedICPOdometry(icp.ICPConfig(num_points=8192, association=mode),
                                 device="cuda").config
    exact = frame_major(scans)
    moved = {k: frame_major(nudged(scans, d, n)) for k, (d, n) in NUDGES.items()}
    st = icp.init_states(cfg, scans.shape[0], device="cuda")
    rows = []
    for f in range(scans.shape[1]):
        batched_stats = icp.StepStats()
        nxt, batched = icp.process_frame_batched(cfg, st, exact[f], batched_stats)
        again = icp.process_frame_batched(cfg, st, exact[f])[1].pose[:, :3, 3]
        for q in range(scans.shape[0]):
            one, stats = cs.sequence_state(st, q), icp.StepStats()
            _, single = icp.process_frame(cfg, one, exact[f, q], stats)
            ref = single.pose[:3, 3]
            row = {
                "mode": mode, "frame": f, "sequence": q,
                "gap_m": float((batched.pose[q, :3, 3] - ref).abs().max()),
                "batched_rerun_m": float((again[q] - batched.pose[q, :3, 3]).abs().max()),
                "single_rerun_m": float(
                    (icp.process_frame(cfg, one, exact[f, q])[1].pose[:3, 3] - ref).abs().max()),
                "iterations_batched": batched_stats.sequence_iterations[q],
                "iterations_single": stats.iterations,
                "converged": stats.iterations < cfg.max_num_alignments,
                "matches_batched": float(batched.num_matches[q]),
                "matches_single": float(single.num_matches),
            }
            for k, frames in moved.items():
                row[k] = float((icp.process_frame(cfg, one, frames[f, q])[1].pose[:3, 3]
                                - ref).abs().max())
            rows.append(row)
        st = nxt
    return rows


def summary(rows: list) -> dict:
    def stable(r, keys):
        return max(r[k] for k in keys) < ATOL_M

    out = {"steps": len(rows), "converged": sum(r["converged"] for r in rows),
           "rerun_max_m": max(max(r["batched_rerun_m"], r["single_rerun_m"]) for r in rows),
           "iterations_equal": sum(r["iterations_batched"] == r["iterations_single"]
                                   for r in rows)}
    for name, keys in (("up1", ("up1",)), ("all_nudges", tuple(NUDGES))):
        held = [r for r in rows if stable(r, keys)]
        over = [r for r in held if r["gap_m"] > ATOL_M]
        conv = [r for r in held if r["converged"]]
        out[name] = {
            "stable": len(held), "over_bar": len(over),
            "over_bar_at_cap": sum(not r["converged"] for r in over),
            "over_bar_max_m": max((r["gap_m"] for r in over), default=0.0),
            "stable_converged": len(conv),
            "stable_converged_gap_max_m": max((r["gap_m"] for r in conv), default=0.0),
            "stable_converged_iterations_equal": sum(
                r["iterations_batched"] == r["iterations_single"] for r in conv),
        }
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/step_nudges.jsonl")
    parser.add_argument("--modes", default="projective,voxel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    scans, _ = cs.batched_worlds()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        for mode in args.modes.split(","):
            rows = mode_rows(mode, scans)
            for r in rows:
                fh.write(json.dumps(r) + "\n")
            print(json.dumps({"mode": mode, **summary(rows),
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
