#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration; ``benchmark/workloads/<name>.json`` its driver, its
traffic and the limits of its check; ``benchmark/drivers/<driver>.py`` the
program's entry it drives; ``benchmark/metrics/<metric>.py`` each metric's
reader. With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled stretch after
the window. The last line of standard output is one JSON object; the last
lines of standard error give each number of the check beside its limit.
Exits 2, and prints no result, without a CUDA card, or where a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the host's share of a step stays steady
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import manifest, runner

    cell = manifest.load_cell(ROOT / "BENCHMARK.json", args.workload)
    try:
        device = runner.require_cards(int(cell.entry["chips"]))
    except runner.NoDevice as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = runner.forbidden_loaded()
    if loaded:
        print(f"error: modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 2
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
