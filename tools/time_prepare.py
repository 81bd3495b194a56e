"""Time the odometry's scan preparation on the card at the odometry cell's
shape: a chunk of 32 whole sweeps of 107-115k rows, 8,192 points drawn a
scan.

Prints one JSON line (and writes it to ``--out``): the keep and take
kernels' device ms (CUDA events over ``--reps`` launches) beside their byte
bounds at 3.35 TB/s and their plain versions on the card; the host ms of
``PWCLONetOdometry._prepare`` of the chunk, split by its spans (the upload,
the keep, the counts' read-back and the draws, the take); and whether its
scans equal the plain preparation's on the CPU, bit for bit. Needs a CUDA
device; imports torch and numpy only beside the package.

    python3 tools/time_prepare.py --out build/time_prepare.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwclonet_pylidarslam_torch.models import PWCLONetConfig  # noqa: E402
from pwclonet_pylidarslam_torch.ops import prepare  # noqa: E402
from pwclonet_pylidarslam_torch.slam.deep_odometry import (  # noqa: E402
    DeepOdometryConfig,
    PWCLONetOdometry,
)
from pwclonet_pylidarslam_torch.utils import timer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=32)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--calls", type=int, default=10, help="timed _prepare calls")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    n = args.points
    scans = [(rng.normal(size=(int(h), 3)) * 20).astype(np.float32)
             for h in rng.integers(107_000, 115_001, args.scans)]
    hits = sum(len(s) for s in scans)

    rows = torch.from_numpy(np.concatenate(scans)).to(dev)
    offsets = torch.from_numpy(np.cumsum([0] + [len(s) for s in scans])).to(dev)
    keep, counts = prepare.keep_rows(rows, offsets)
    counts = counts.tolist()
    idx = torch.from_numpy(np.stack([prepare.draw(c, n) for c in counts]).astype(np.int32)).to(dev)
    out = prepare.prepare(rows, offsets, n)
    torch.cuda.synchronize()
    kept = sum(counts)
    taken = args.scans * n
    keep_bytes = 12 * hits + 4 * kept + 8 * (args.scans + 1) + 4 * args.scans
    take_bytes = taken * (4 + 4 + 12 + 12) + 8 * (args.scans + 1)
    result = {
        "card": card(), "scans": args.scans, "rows": hits, "kept": kept, "points": n,
        "keep_ms": device_ms(lambda: prepare.keep_rows(rows, offsets), args.reps),
        "keep_bound_ms": 1e3 * keep_bytes / HBM_BYTES_PER_S, "keep_bytes": keep_bytes,
        "take_ms": device_ms(lambda: prepare.take_rows(rows, offsets, keep, idx, out=out),
                             args.reps),
        "take_bound_ms": 1e3 * take_bytes / HBM_BYTES_PER_S, "take_bytes": take_bytes,
        "keep_plain_ms": device_ms(lambda: prepare.keep_rows_plain(rows, offsets), 5),
        "take_plain_ms": device_ms(lambda: prepare.take_rows_plain(rows, offsets, keep, idx),
                                   args.reps),
    }

    odo = PWCLONetOdometry(config=DeepOdometryConfig(model=PWCLONetConfig(), num_points=n),
                           device=dev)
    odo._prepare(scans)  # the upload buffer grown once
    torch.cuda.synchronize()
    wall, by_span = [], defaultdict(list)
    for _ in range(args.calls):
        with timer.recording() as rec:
            t0 = time.perf_counter()
            odo._prepare(scans)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        spent = defaultdict(float)
        for name, _, _, start, end in rec.spans:
            spent[name] += 1e-6 * (end - start)
        for name, ms in spent.items():
            by_span[name].append(ms)
    want = PWCLONetOdometry(config=odo.config, device="cpu")._prepare(scans)
    result.update({
        "prepare_ms": statistics.median(wall), "prepare_ms_runs": wall,
        "prepare_ms_by_span": {k: statistics.median(v) for k, v in by_span.items()},
        "bit_equal": bool(torch.equal(odo._prepare(scans).cpu(), want)),
    })
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if result["bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
