"""The data-parallel train step over two gloo ranks against ``train_step``
in one process, over several batch seeds, on the CPU.

The step's result moves with the order in which the BatchNorm moments are
summed, and a warped point's nearest neighbour can flip on such a change, so
a single seed says little about how far the step sits inside the reference's
bar (``tests/test_parallel.py:28-68``: loss rtol 1e-4; the parameters'
differences after one step under 1e-4 at the 99.9th percentile and 1e-2 at
most). For each seed this prints one JSON line: the loss's relative
difference, the 99.9th percentile and the largest parameter difference, and
the share of parameters that differ by more than 1e-4. The model and batches
are ``tests/test_torch_parallel.py``'s (128 points, batch 8)::

    python tools/parallel_step_seeds.py --seeds 0,1,2,3,4,5

Takes about a minute on two CPU cores.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwclonet_pylidarslam_torch import parallel as par  # noqa: E402
from pwclonet_pylidarslam_torch.models import PWCLONetConfig  # noqa: E402
from pwclonet_pylidarslam_torch.train import state as ts  # noqa: E402

CFG = ts.TrainConfig(model=PWCLONetConfig(num_points=128, sa_npoints=(32, 16, 8, 4),
                                          sa_nsamples=(8, 8, 4, 4)), total_steps=10)


def batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"xyz1": rng.normal(size=(8, 128, 3)).astype(np.float32) * 8,
            "xyz2": rng.normal(size=(8, 128, 3)).astype(np.float32) * 8,
            "gt_params": np.tile(np.asarray([[0.1, 0, 0, 1, 0, 0, 0]], np.float32), (8, 1))}


def one_step(seed: int, step) -> tuple:
    state = ts.create_train_state(CFG, 0, device="cpu")
    log = step(state, batch(seed))
    return float(log["loss"]), torch.cat([p.detach().reshape(-1)
                                          for p in state.model.parameters()]).numpy()


def rank_main(rank: int, init_file: str, seeds: list, out: str) -> None:
    torch.set_num_threads(1)
    par.initialize(init_method=f"file://{init_file}", world_size=2, rank=rank, device="cpu")
    try:
        step = par.make_parallel_train_step(CFG, par.make_mesh(device="cpu"))
        results = [one_step(seed, step) for seed in seeds]
        if rank == 0:
            np.savez(out, loss=np.asarray([r[0] for r in results]),
                     params=np.stack([r[1] for r in results]))
    finally:
        par.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="0,1,2,3,4,5")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as work:
        out = str(Path(work, "ranks.npz"))
        mp.spawn(rank_main, args=(str(Path(work, "rendezvous")), seeds, out), nprocs=2,
                 join=True)
        two = np.load(out)
        for i, seed in enumerate(seeds):
            loss, params = one_step(seed, lambda s, b: ts.train_step(CFG, s, b))
            d = np.abs(two["params"][i] - params)
            print(json.dumps({"seed": seed, "loss_rel": abs(float(two["loss"][i]) / loss - 1.0),
                              "param_q999": float(np.quantile(d, 0.999)),
                              "param_max": float(d.max()),
                              "share_over_1e-4": float((d > 1e-4).mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
