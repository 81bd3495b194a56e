"""Data-parallel scaling harness: PWCLO-Net training pairs/s at mesh sizes
1 .. world size, and the efficiency ``eff(n) = pairs/s(n) / (n ·
pairs/s(1))``.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/scaling.py``.
Each mesh size n trains on the first n ranks (a ``DeviceMesh`` over them;
the other ranks wait) through ``make_parallel_train_step`` with
``batch_per_device`` pairs a rank, from one seeded state, on random clouds.
A step's time is the slowest rank's, on the host clock around ``steps``
steps that end in a synchronize. Run, on the card::

    python -m pwclonet_pylidarslam_torch.parallel.scaling              # one process
    torchrun --nproc-per-node 4 -m pwclonet_pylidarslam_torch.parallel.scaling

Rank 0 prints one JSON line a mesh size, then a summary line
(``"metric": "dp_scaling_efficiency"``) where there is more than one size,
and writes them all to ``--out``. ``--device cpu`` runs gloo on the CPU,
where the ranks share the host's cores: the efficiency then measures core
contention, not scaling.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.parallel.data_parallel import make_parallel_train_step
from pwclonet_pylidarslam_torch.parallel.distributed import initialize, shutdown
from pwclonet_pylidarslam_torch.parallel.mesh import make_mesh


@dataclass(frozen=True)
class ScalingConfig:
    num_points: int = 8192
    batch_per_device: int = 8
    warmup_steps: int = 2
    steps: int = 10
    sizes: Optional[Sequence[int]] = None  # default: 1, 2, 4, ... <= world size
    tiny: bool = False  # the small model plan, to check the harness on the CPU
    device: str = "cuda"


def _mesh_sizes(world: int, sizes: Optional[Sequence[int]]) -> List[int]:
    if sizes is not None:
        return [s for s in sizes if s <= world]
    out, s = [], 1
    while s <= world:
        out.append(s)
        s *= 2
    return out


def random_batch(b: int, n: int, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``b`` pairs of ``n`` random points (normal, scale 8 m) with an
    identity ground truth, made from ``seed`` on ``device``."""
    rng = np.random.default_rng(seed)
    gt = np.tile(np.asarray([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]], np.float32), (b, 1))
    return {
        "xyz1": torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32) * 8).to(device),
        "xyz2": torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32) * 8).to(device),
        "gt_params": torch.from_numpy(gt).to(device),
    }


def measure_scaling(config: ScalingConfig = ScalingConfig()) -> List[Dict]:
    """One record a mesh size: ``{"devices", "batch", "ms_per_step",
    "pairs_per_s", "efficiency"}``, the same on every rank. Every rank of the
    world calls it."""
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.train.state import TrainConfig, create_train_state

    dev = resolve_device(config.device)
    initialize(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if config.tiny:
        model_cfg = PWCLONetConfig(num_points=256, sa_npoints=(64, 32, 16, 8),
                                   sa_nsamples=(8, 8, 8, 4))
    else:
        model_cfg = PWCLONetConfig(num_points=config.num_points)
    n = model_cfg.num_points
    train_cfg = TrainConfig(model=model_cfg, total_steps=1000)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    records: List[Dict] = []
    base = None
    for n_dev in _mesh_sizes(dist.get_world_size(), config.sizes):
        mesh = make_mesh(n_data=n_dev, device=dev)  # every rank of the world takes part
        b = config.batch_per_device * n_dev
        elapsed = torch.zeros((), dtype=torch.float64, device=dev)
        if dist.get_rank() < n_dev:
            state = create_train_state(train_cfg, seed=0, device=dev)
            step = make_parallel_train_step(train_cfg, mesh)
            batch = random_batch(b, n, seed=1, device=dev)
            for _ in range(config.warmup_steps):
                step(state, batch)
            sync()
            t0 = time.perf_counter()
            for _ in range(config.steps):
                step(state, batch)
            sync()
            elapsed.fill_(time.perf_counter() - t0)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)  # the slowest rank's
        seconds = float(elapsed)
        pairs_per_s = b * config.steps / seconds
        base = pairs_per_s if base is None else base
        records.append({
            "devices": n_dev,
            "batch": b,
            "ms_per_step": seconds / config.steps * 1000.0,
            "pairs_per_s": pairs_per_s,
            "efficiency": pairs_per_s / (n_dev * base),
        })
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", type=str, default=None, help="comma list, e.g. 1,2,4")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch-per-device", type=int, default=8)
    parser.add_argument("--num-points", type=int, default=8192)
    parser.add_argument("--tiny", action="store_true", help="tiny model (harness check)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the records and the summary to this JSON file")
    args = parser.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")] if args.sizes else None
    owned = not dist.is_initialized()
    try:
        records = measure_scaling(ScalingConfig(
            num_points=args.num_points, batch_per_device=args.batch_per_device,
            steps=args.steps, sizes=sizes, tiny=args.tiny, device=args.device))
        world = dist.get_world_size()
        if dist.get_rank() != 0:
            return 0
        for record in records:
            print(json.dumps(record))
        summary = None
        if len(records) > 1:
            summary = {"metric": "dp_scaling_efficiency", "max_devices": records[-1]["devices"],
                       "efficiency": records[-1]["efficiency"]}
            print(json.dumps(summary))
        if args.out:
            cuda = resolve_device(args.device).type == "cuda"
            payload = {
                "platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "n_devices": world,
                "tiny": args.tiny,
                "records": records,
            }
            if not cuda:
                payload["note"] = ("CPU harness check: the ranks share the host's cores; "
                                   "efficiency rows are core-bound, not scaling evidence")
            if summary is not None:
                payload["summary"] = summary
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1)
        return 0
    finally:
        if owned:
            shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
