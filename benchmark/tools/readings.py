#!/usr/bin/env python3
"""Read a cell's check numbers over many seeds in one process, for the
program and for its control, on the card: the readings its limits are set
from.

    python3 benchmark/tools/readings.py --workload <name> --seeds 1,2,3
        [--control float32|tf32|bfloat16] [--seconds S] [--program 0|1]

For each seed: the cell's set-up, then (where the cell's check reads the
window's answers) a window of ``--seconds``, then the program's readings
against the reference, and, with ``--control``, the reference computed in
that precision put in the program's place. One JSON line a seed, with the
per-step losses and the worst leaves of a training cell.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--half-batch", type=int, default=0,
                   help="also read a training cell's fault: half of each batch left out")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.harness import compare, manifest, runner

    cell = manifest.load_cell(ROOT / "BENCHMARK.json", args.workload)
    device = runner.require_cards(int(cell.entry["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = cell.driver.Driver(cell.config, cell.workload, seed, device)
        driver.setup()
        if args.seconds > 0:
            runner.measure(driver, args.seconds, device)
        driver.free()
        torch.cuda.empty_cache()
        out = {"workload": args.workload, "seed": seed, "limits": cell.workload["limits"]}
        if args.program:
            if driver.train:
                prog, ref = driver.program(), driver.reference()
                out["program"] = {**compare.train_readings(prog, ref),
                                  "batch": compare.batch_gap(driver.first_batches,
                                                             driver.reference_batches())}
                out["detail"] = compare.train_detail(prog, ref)
            else:
                g = driver.gaps()
                out["program"] = compare.pose_readings(g)
                out["gap_quantiles"] = np.percentile(g, [50, 90, 99, 100]).tolist()
                out["poses"] = len(g)
        if args.control:
            if driver.train:
                out["control"] = driver.control_readings(args.control)
            else:
                g = driver.gaps(args.control)
                out["control"] = compare.pose_readings(g)
                out["control_gap_quantiles"] = np.percentile(g, [0, 10, 50, 99, 100]).tolist()
            out["control_precision"] = args.control
        if args.half_batch and driver.train:
            out["fault_half_batch"] = driver.fault_readings()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
