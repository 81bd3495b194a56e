#!/usr/bin/env python3
"""Time the FPS and kNN kernels of a tree's ``pwclonet_pylidarslam_torch`` at
every shape one full-width PWCLO-Net forward gives them, on one CUDA card.

    python3 tools/time_point_kernels.py [--root DIR] [--reps N] [--per-frame]

``--root`` is the directory that holds the package (default: this
repository). To compare two versions of a kernel, unpack the other tree
somewhere (``git archive <commit> pwclonet_pylidarslam_torch | tar -x -C
build/parent``) and run this script on both roots in turns on one card:
each run is a process of its own, so each builds and loads its own kernels.

``--per-frame`` times the siamese pyramid's launches as two of one frame
each (how the network launched them before it stacked both frames on the batch
axis) and not as one of two frames.

Prints the card's name and power limit and one JSON object: device
milliseconds per launch (the launches queued behind a sleeping kernel, so
that the host's pace is not in them) by kernel and shape, and their sum
weighted by the launches of one forward.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (S level, N level, k, launches per forward, of the paired pyramid): levels
# index the pyramid 8192 / 2048 / 1024 / 256 / 64; "b" marks the other frame
KNN_SHAPES = [
    ("1", "0", 32, 1, True), ("2", "1", 32, 1, True), ("3", "2", 16, 1, True),
    ("4", "3", 16, 1, True), ("4", "3", 16, 1, False),
    ("3", "3b", 32, 1, False), ("3", "3", 4, 2, False),
    ("3", "4", 8, 2, False), ("2", "3", 8, 2, False), ("1", "2", 8, 2, False),
    ("3", "3b", 6, 1, False), ("2", "2b", 6, 1, False), ("1", "1b", 6, 1, False),
    ("2", "2", 4, 1, False), ("1", "1", 4, 1, False),
]
FPS_SHAPES = [("0", 2048, 1, True), ("1", 1024, 1, True), ("2", 256, 1, True),
              ("3", 64, 1, True), ("3", 64, 1, False)]


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn()``: ``reps`` calls queued behind a
    sleeping kernel, between two CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(60_000_000)  # tens of ms: the host queues every call meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--per-frame", action="store_true",
                        help="the pyramid's launches as two of one frame, not one of two")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pwclonet_pylidarslam_torch import ops
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence,
    )
    from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry

    scans, _ = generate_sequence(SyntheticSequenceConfig(n_frames=2, seed=0))
    odo = PWCLONetOdometry(None, DeepOdometryConfig(), seed=0)
    both = torch.from_numpy(np.stack([odo._prepare(s) for s in scans])).cuda()  # (2, 8192, 3)
    levels = [both]
    for npoint in (2048, 1024, 256, 64):
        idx = ops.furthest_point_sample(levels[-1], npoint)
        levels.append(ops.gather_points(levels[-1], idx))

    def cloud(name: str, paired: bool) -> torch.Tensor:
        lv = levels[int(name[0])]
        if paired:
            return lv
        return lv[1:2] if name.endswith("b") else lv[0:1]

    out = {"root": args.root, "knn": [], "fps": []}
    def split(launches: int, paired: bool) -> tuple:
        return (2 * launches, False) if paired and args.per_frame else (launches, paired)

    for s, n, k, launches, paired in KNN_SHAPES:
        launches, paired = split(launches, paired)
        q, r = cloud(s, paired), cloud(n, paired)
        ms = device_ms(lambda: ops.knn(q, r, k), args.reps)
        out["knn"].append({"shape": f"B={q.shape[0]} S={q.shape[1]} N={r.shape[1]} k={k}",
                           "launches": launches, "ms": ms})
    for n, npoint, launches, paired in FPS_SHAPES:
        launches, paired = split(launches, paired)
        p = cloud(n, paired)
        ms = device_ms(lambda: ops.furthest_point_sample(p, npoint), max(3, args.reps // 4))
        out["fps"].append({"shape": f"B={p.shape[0]} N={p.shape[1]} npoint={npoint}",
                           "launches": launches, "ms": ms})
    for name in ("knn", "fps"):
        out[f"{name}_ms_per_forward"] = sum(c["launches"] * c["ms"] for c in out[name])
        out[f"{name}_launches_per_forward"] = sum(c["launches"] for c in out[name])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
