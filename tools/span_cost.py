#!/usr/bin/env python3
"""What the program's spans cost, how their clock lines up with the CUDA
profiler's, and how a profiled stretch of each benchmark cell splits by span.

    python3 tools/span_cost.py [--cells a,b] [--seed N] [--out build/span_cost.json]

On a CUDA card:

1. host ns a ``span()`` takes with the recording off and on, over 10**6
   ``with`` blocks each;
2. the clock offset: 100 spans, each around one ``torch.cuda._sleep``
   launch, under ``torch.profiler``; each span should contain its
   ``cudaLaunchKernel`` event, and the largest overshoot is printed;
3. for each cell, after its set-up: the profiled stretch twelve times, the
   recording off, on, on, off three times over (``trace.profile`` as the
   harness has it, then as ``benchmark/harness/program_trace.py`` wraps
   it), each stretch's wall time and the on / off ratio of the means; and of
   the on stretches: the device seconds by span against the
   stretch's summed device seconds, the idle seconds outside any span and in
   the self time of the call-level spans as shares of the idle seconds (gaps
   of 20 us or more), the threads the spans opened on, and every per-layer
   metric of the cell that the stretch gives.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

CALL_LEVEL = ("odometry.call", "train.block", "train.step")
CELLS = ("pwclonet-odometry-seq32", "pwclonet-train-b8", "pointnet2-semseg-train-b32")


def span_ns(timer, n: int = 10 ** 6):
    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with timer.span("cost.loop"):
                pass
        return (time.perf_counter() - t0) / n * 1e9

    off = loop()
    with timer.recording():
        on = loop()
    return {"off_ns": off, "on_ns": on}


def clock_offset(timer, torch, launches: int = 100):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, timer.recording() as rec:
        for _ in range(launches):
            with timer.span("cost.sleep"):
                torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    calls = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name() == "cudaLaunchKernel"]
    worst, contained = 0, 0
    for _, _, _, s0, s1 in rec.spans:
        mid = (s0 + s1) / 2
        l0, l1 = min(calls, key=lambda c: abs((c[0] + c[1]) / 2 - mid))
        over = max(0, s0 - l0, l1 - s1)
        worst = max(worst, over)
        contained += over == 0
    return {"spans": len(rec.spans), "launch_events": len(calls), "contained": contained,
            "largest_overshoot_ns": worst}


def cell_split(name: str, seed: int, device, torch):
    from benchmark.harness import manifest, program_trace, runner, trace, work

    plain = trace.profile
    cell = manifest.load_cell(ROOT / "BENCHMARK.json", name)
    program_trace.install()
    driver = cell.driver.Driver(cell.config, cell.workload, seed, device)
    driver.setup()
    torch.cuda.synchronize()
    walls, ons = {"off": [], "on": []}, []
    for on in (False, True, True, False) * 3:
        stretch = (trace.profile if on else plain)(driver.stretch, device)
        walls["on" if on else "off"].append(stretch.window_s)
        if on:
            ons.append(stretch)
    walls["on_over_off"] = sum(walls["on"]) / sum(walls["off"])
    out = {"stretch_wall_s": walls, "stretches": []}
    for stretch in ons[:2]:
        p = stretch.program
        device_total = sum(e - s for _, s, e in stretch.device_ops)
        by_span = p.by_name(p.device_s)
        long_idle = sum(p.idle_s.values())
        self_call = sum(v for i, v in p.idle_s.items()
                        if i is not None and p.spans[i][0] in CALL_LEVEL)
        rec = runner.Record(setup_s=0.0, window=runner.Window(), counters={},
                            work=work.work_of(cell.config, 1, driver.train, driver.fused),
                            train=driver.train, batch=driver.batch, stretch=stretch)
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_modules[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = value
        out["stretches"].append({
            "window_s": stretch.window_s, "busy_s": stretch.busy_s,
            "device_op_s": device_total, "device_by_span_s": sum(by_span.values()),
            "device_by_span": sorted(by_span.items(), key=lambda kv: -kv[1]),
            "idle_s": stretch.window_s - stretch.busy_s, "idle_long_s": long_idle,
            "idle_short_s": p.short_idle_s,
            "idle_outside_share": p.idle_s.get(None, 0.0) / long_idle if long_idle else None,
            "idle_call_self_share": self_call / long_idle if long_idle else None,
            "idle_by_span": sorted(p.by_name(p.idle_s).items(), key=lambda kv: -kv[1]),
            "idle_gaps": stretch.top_idle(40),
            "span_threads": sorted({s[2] for s in p.spans}), "recording_thread": p.thread,
            "counters": p.counters, "calls": stretch.calls, "units": stretch.units,
            "span_seconds": _span_seconds(p), "metrics": metrics,
        })
    driver.free()
    torch.cuda.empty_cache()
    return out


def _span_seconds(p):
    out = defaultdict(float)
    for name, _, _, s, e in p.spans:
        out[name] += (e - s) * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 777)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_cost.json"))
    args = ap.parse_args(argv)

    import torch

    from pwclonet_pylidarslam_torch.utils import timer

    if not torch.cuda.is_available():
        print("error: this tool measures a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result = {"card": torch.cuda.get_device_name(device), "span": span_ns(timer),
              "clock": clock_offset(timer, torch), "cells": {}}
    print(json.dumps({k: result[k] for k in ("card", "span", "clock")}), flush=True)
    for name in filter(None, args.cells.split(",")):
        result["cells"][name] = cell_split(name, args.seed, device, torch)
        brief = {k: v for k, v in result["cells"][name]["stretches"][-1].items()
                 if k not in ("idle_gaps", "span_seconds", "idle_by_span")}
        print(name, json.dumps(result["cells"][name]["stretch_wall_s"]), json.dumps(brief),
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
