#!/usr/bin/env python3
"""Run the PyTorch port of PWCLO-Net odometry and training on one NVIDIA GPU
and check it.

    python3 chip_smoke.py [--profile] [--kernels]

from the root of the repository, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each of which must pass:

1. build the hand-written kernels of ``pwclonet_pylidarslam_torch/csrc``
   with ``nvcc`` for ``sm_90a``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the full-width main path gives it (B=1, and B=2 where the siamese
   pyramid stacks both frames): FPS indices identical (and the paired launch
   at most 1.1 x the time of one frame's), kNN distances and indices
   ``torch.equal`` at every shape of the path (k = 4, 6, 8, 16, 32), on an
   integer grid and on duplicated points, gather bit-exact (also at the train
   step's widest groupings: B=16 M=32,768 C=19 and B=8 M=16,384 C=67); FPS
   at every cluster size and thread count and kNN at 2, 4 and 8 queries a
   block give the same results and are timed; the fused MLP + max-pool
   within atol 3e-5 / rtol 1e-4 and the fused attentive aggregate within
   atol 5e-5 / rtol 1e-4 (both multiply in 3xTF32 on the tensor cores and
   sum in another order than the library's matmul), also at KITTI's reach of
   80 m, on weights folded from perturbed BatchNorm statistics; the MLP at
   every path shape with other tiles than its wrapper's (bit-equal, timed); the
   scatter-add (the gather's backward) at shapes of a train step's backward
   (three batch-8 ones, and the B=16 level-2 grouping of the stacked
   pyramid): ``torch.equal`` to the plain version on the CPU copy of its
   inputs (a sequential loop over m, the order the kernel promises),
   bit-equal to a second launch, and within 1e-5 of the largest segment's sum of magnitudes
   of the plain version on the card (whose float atomics add in another
   order);
3. run the small config (256 points) on the card and on the CPU with the
   same seeded weights and inputs, and with ``fused_eval=True`` on the card
   against the unfused card run: pose params within atol 1e-4 / rtol 1e-3;
   then one train-mode forward + backward (dropout off) on the card against
   the CPU from the same state: loss within rtol 1e-5, every gradient leaf
   within atol 1e-4 + 1e-3 of the leaf's largest magnitude;
4. drive the main path at full width (the default ``PWCLONetConfig``: 8192
   points, the reference channel plan, float32, seeded random weights) over
   a corridor sequence from the port's own generator, once with
   ``fused_eval=True`` (the shipped SLAM configuration; 10 frames) and once
   unfused (4 frames): ``process_next_frame`` over every frame, then
   ``process_sequence`` over the same frames. The launch counters are zeroed
   just before each drive and read just after; every kernel of the path must
   have launched, and exactly its count per forward times the forwards (the
   unfused path launches neither fused kernel); the poses must be finite
   SE(3). One full-width forward with ``compute_dtype="bfloat16"`` must give
   finite unit-quaternion poses;
5. train at full width through ``PWCLONetTrainer`` on the card (batch 8, 8192
   points, float32, the random-cloud batches of ``train_net_torch.py``): six
   steps of ``train_epoch`` with the counters zeroed before and read after
   (FPS 5, kNN 19, gather 24 and scatter-add 18 launches a step, the fused
   kernels none), every loss and gradient norm finite, no step skipped; the
   same step from the same state and generator twice gives bit-identical
   gradients; the checkpoint loads into a fused ``PWCLONetOdometry``, which
   gives finite SE(3) poses; then the fast-lane learning recipe (small
   config, 40 epochs) on the card: losses fall, relative-pose RMSE under
   0.40 of the per-frame travel and under 0.6 of the untrained net's;
6. time the train step (CUDA events around each of six steps, forward and
   backward apart, device launches of one profiled step, peak memory), the
   forward at B=1 (unfused, fused, fused, unfused in turns),
   ``process_sequence``, and each kernel beside its plain version, one
   PyTorch library call where one computes the same function, and its bound
   (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s, the H100 SXM's
   published peaks; for the two fused kernels, which multiply in 3xTF32,
   three TF32 products for each over 495 TFLOP/s, their fp32 bound beside).
   A kernel's ``ms`` is the device's time per call, taken with the calls
   queued behind a sleeping kernel; ``call_ms`` is the time
   per call when Python launches them one after another. FPS also gets
   ``chain_bound_ms``: the time of its chain of ``npoint - 1`` dependent
   steps when each does only its key reduction and its wait, measured with
   the same kernel stripped of the distance update.

Prints the card's name and power limit, a ``{"metrics": ...}`` line, a
``{"variants": ...}`` line (the FPS kernel's time at each cluster size and
thread count, the kNN kernel's at each number of queries a block, the MLP
kernel's at each tile), a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if CUDA is unavailable or any check
fails. ``--profile`` profiles one full-width forward of each configuration
and prints the tables of those and of the train step on stderr; device time
by kernel, launches and idle share go into the metrics. ``--kernels`` stops
after phase 2 and prints the cases and the variants (no last line).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from pwclonet_pylidarslam_torch.data.synthetic import (  # noqa: E402
    SyntheticSequenceConfig,
    generate_sequence,
)
from pwclonet_pylidarslam_torch import ops  # noqa: E402
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig  # noqa: E402
from pwclonet_pylidarslam_torch.models.layers import PointMLP  # noqa: E402
from pwclonet_pylidarslam_torch.ops import _cuda  # noqa: E402
from pwclonet_pylidarslam_torch.ops import fps as tfps  # noqa: E402
from pwclonet_pylidarslam_torch.ops import gather as tgather  # noqa: E402
from pwclonet_pylidarslam_torch.ops.costvolume import attentive_aggregate_plain  # noqa: E402
from pwclonet_pylidarslam_torch.ops.knn import (  # noqa: E402
    _knn_cuda,
    knn,
    knn_plain,
    pairwise_sqdist,
)
from pwclonet_pylidarslam_torch.ops import mlp as mlp_mod  # noqa: E402
from pwclonet_pylidarslam_torch.ops.mlp import mlp_maxpool_plain  # noqa: E402
from pwclonet_pylidarslam_torch.ops.tf32x3 import max_tile_rows, mlp_tile, sm_count  # noqa: E402
from pwclonet_pylidarslam_torch.models.layers import discard_batch_stats  # noqa: E402
from pwclonet_pylidarslam_torch.models.pwclonet import PoseCalculator  # noqa: E402
from pwclonet_pylidarslam_torch.slam.deep_odometry import (  # noqa: E402
    DeepOdometryConfig,
    PWCLONetOdometry,
)
from pwclonet_pylidarslam_torch.train import state as tstate  # noqa: E402
from pwclonet_pylidarslam_torch.train.fast_lane import run_fast_lane_recipe  # noqa: E402
from pwclonet_pylidarslam_torch.train.losses import pwclonet_loss  # noqa: E402
from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig  # noqa: E402
import train_net_torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores, published
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores, published
# launches of each kernel per forward pair, read off models/pwclonet.py (the
# pyramid samples and groups both frames in one launch, stacked on the batch):
# FPS: 4 pyramid levels + the flow-embedding SetConv;
# kNN: 4 + 1 SetConv, 2 per cost volume x 4, 2 SetUpConvs x 3 levels;
# gather: 2 per SetConv x 5, 2 per cost volume x 4, 1 per SetUpConv x 6;
# with fused_eval, mlp_maxpool: 1 per pyramid level and frame (8), 1 for the
# flow-embedding SetConv and 1 per SetUpConv x 6; attentive_aggregate: 2 per
# cost volume x 4.
LAUNCHES_PER_FORWARD = {
    False: {"fps": 5, "knn": 19, "gather": 24, "scatter_add": 0, "mlp_maxpool": 0,
            "attentive_aggregate": 0},
    True: {"fps": 5, "knn": 19, "gather": 24, "scatter_add": 0, "mlp_maxpool": 15,
           "attentive_aggregate": 8},
}
# a train step takes the unfused graph. Of its 24 gathers, 18 have a source
# that requires grad and an output that the loss reads: the groupings of the
# pyramid levels above the first (3, both frames in one), the flow-embedding
# SetConv, 2 per cost volume x 4 and 1 per SetUpConv x 6. Each runs one
# scatter-add in the backward.
LAUNCHES_PER_TRAIN_STEP = {"fps": 5, "knn": 19, "gather": 24, "scatter_add": 18,
                           "mlp_maxpool": 0, "attentive_aggregate": 0}
# (S, K, Cin, widths) of the fused MLP's calls in a full-width fused forward
# at B=1, as tools/time_point_kernels.py records them; the one with the most
# work first
MLP_PATH_SHAPES = [
    (2048, 8, 67, (128, 64)),  # level-1 SetUpConv
    (2048, 32, 6, (8, 8, 16)),  # level-1 SetConv
    (1024, 32, 19, (16, 16, 32)),
    (256, 16, 35, (32, 32, 64)),
    (64, 16, 67, (64, 64, 128)),
    (64, 16, 67, (128, 64, 64)),  # SetConv on the flow embedding
    (1024, 8, 67, (128, 64)),
    (256, 8, 67, (128, 64)),
]
KERNELS = {
    "fps": ("pwclonet_pylidarslam_torch/csrc/fps.cu",
            "pwclonet_pylidarslam_tpu/ops/pallas/fps_kernel.py:116"),
    "knn": ("pwclonet_pylidarslam_torch/csrc/knn.cu",
            "pwclonet_pylidarslam_tpu/ops/pallas/knn_kernel.py:103"),
    "gather": ("pwclonet_pylidarslam_torch/csrc/gather.cu",
               "pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py:58"),
    "scatter_add": ("pwclonet_pylidarslam_torch/csrc/scatter_add.cu",
                    "pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py:107"),
    "mlp_maxpool": ("pwclonet_pylidarslam_torch/csrc/mlp_maxpool.cu",
                    "pwclonet_pylidarslam_tpu/ops/pallas/mlp_kernel.py:61"),
    "attentive_aggregate": ("pwclonet_pylidarslam_torch/csrc/attentive_aggregate.cu",
                            "pwclonet_pylidarslam_tpu/ops/pallas/costvolume_kernel.py:122"),
}
N_FRAMES = 10  # corridor sequence: 9 pairs one by one, then 9 in one batch
N_FRAMES_UNFUSED = 4  # the unfused path runs over the first frames only
TRAIN_BATCH = 8
TRAIN_STEPS = 6  # one epoch of the full-width training drive
SMALL = PWCLONetConfig(num_points=256, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))


class CheckFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    log(f"ok: {what}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def sleep_cycles_per_ms() -> float:
    """How many cycles ``torch.cuda._sleep`` spins in a millisecond on this card."""
    cycles = 20_000_000
    return cycles / time_ms(lambda: torch.cuda._sleep(cycles), reps=2, warmup=1)


def device_ms(fn, reps: int, warmup: int = 2) -> dict:
    """Times of ``fn()``: ``call_ms`` as :func:`time_ms` gives it (calls
    issued one after another from Python, so a short kernel shows its
    wrapper's host time), and ``ms``, the device's own time per call: the
    same calls queued behind a sleeping kernel, so that the host runs ahead
    and the card executes them back to back. Where the paced calls already
    take more than 50 ms in all, the device is what paces them (or the
    function is driven from the host by nature) and ``ms`` is ``call_ms``."""
    call_ms = time_ms(fn, reps, warmup)
    if call_ms * reps > 50.0:
        return {"ms": call_ms, "call_ms": call_ms}
    sleep_cycles = int(2.0 * call_ms * reps * sleep_cycles_per_ms())
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / reps, "call_ms": call_ms}


def kernel_times(kernel, plain, library, reps: int, plain_reps: int) -> dict:
    """``ms``/``call_ms`` of the kernel's wrapper, ``plain_ms`` and
    ``library_ms`` (device times, see :func:`device_ms`)."""
    out = device_ms(kernel, reps)
    out["plain_ms"] = device_ms(plain, plain_reps, warmup=1)["ms"]
    out["library_ms"] = None if library is None else device_ms(library, reps)["ms"]
    return out


def bound_ms(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------


def fps_case(points: torch.Tensor, npoint: int) -> dict:
    out = tfps.furthest_point_sample(points, npoint)
    ref = tfps.furthest_point_sample_plain(points, npoint)
    err = (out.long() - ref.long()).abs().max().item()
    b, n, _ = points.shape
    check(err == 0, f"fps B={b} {n}->{npoint}: kernel indices identical to plain")
    # per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare
    nbytes, flops = b * n * 3 * 4 + b * npoint * 4, 10.0 * b * n * (npoint - 1)
    bnd, by = bound_ms(nbytes, flops)
    # the chain of npoint - 1 dependent steps, each at least one sample-wide
    # key reduction and one wait: the same kernel without its distance update
    skeleton = device_ms(lambda: tfps._furthest_point_sample_cuda(points, npoint, None,
                                                                  skeleton=True), 10)["ms"]
    return {
        "shape": f"B={b} N={n} npoint={npoint}", "max_abs_err": float(err),
        "bound_ms": bnd, "bound_by": by, "chain_bound_ms": skeleton * (npoint - 1) / npoint,
        **kernel_times(lambda: tfps.furthest_point_sample(points, npoint),
                       lambda: tfps.furthest_point_sample_plain(points, npoint), None, 10, 2),
    }


def fps_variants(points: torch.Tensor, npoint: int) -> list:
    """The FPS kernel at every cluster size (blocks a sample) and thread count
    it takes for this sample, each held against the kernel's own choice and
    timed; the first entry is the kernel's own choice."""
    b, n, _ = points.shape
    ref = tfps.furthest_point_sample(points, npoint)
    rows = [{"cluster": 0, "threads": 0, **device_ms(
        lambda: tfps.furthest_point_sample(points, npoint), 10)}]
    for threads in (1024, 512, 256, 128, 64):
        if not n / 16 <= threads <= max(32, n):
            continue  # the kernel keeps at most 16 points a thread, and no idle warps here
        for cluster in (1, 2, 4, 8):
            if threads // cluster < 32:
                continue
            run = functools.partial(tfps._furthest_point_sample_cuda, points, npoint, None,
                                    cluster=cluster, threads=threads)
            check(torch.equal(run(), ref),
                  f"fps {n}->{npoint} cluster={cluster} threads={threads}: same picks")
            skeleton = device_ms(functools.partial(run, skeleton=True), 10)["ms"]
            rows.append({"cluster": cluster, "threads": threads, "skeleton_ms": skeleton,
                         **device_ms(run, 10)})
    return [{"shape": f"B={b} N={n} npoint={npoint}", **r} for r in rows]


def knn_case(query: torch.Tensor, ref: torch.Tensor, k: int, what: str = "") -> dict:
    d, i = knn(query, ref, k)
    pd, pi = knn_plain(query, ref, k)
    b, s, _ = query.shape
    n = ref.shape[1]
    name = f"B={b} S={s} N={n} k={k}" + (f" ({what})" if what else "")
    err = (d - pd).abs().max().item()
    check(torch.equal(d, pd), f"knn {name}: distances equal to plain to the bit (max {err:.3g})")
    check(torch.equal(i, pi), f"knn {name}: indices equal to plain "
          f"({int((i != pi).sum())} positions differ)")
    # per pair: 3 mul + 2 add (cross), 1 add, 1 mul, 1 sub, 1 max, 1 compare
    nbytes, flops = (b * s * 3 + b * n * 3) * 4 + b * s * k * 8, 10.0 * b * s * n
    bnd, by = bound_ms(nbytes, flops)
    full = pairwise_sqdist(query, ref)
    return {
        "shape": name, "max_abs_err": err,
        "bound_ms": bnd, "bound_by": by,
        # library: torch.topk on the precomputed distance matrix (the matrix not timed)
        **kernel_times(lambda: knn(query, ref, k), lambda: knn_plain(query, ref, k),
                       lambda: torch.topk(full, k, dim=-1, largest=False), 20, 3),
    }


def knn_variants(query: torch.Tensor, ref: torch.Tensor, k: int) -> list:
    """The kNN kernel at 2, 4 and 8 queries a block, each held against the
    kernel's own choice and timed; the first entry is the kernel's own choice."""
    d, i = knn(query, ref, k)
    name = f"B={query.shape[0]} S={query.shape[1]} N={ref.shape[1]} k={k}"
    rows = [{"warps": 0, **device_ms(lambda: knn(query, ref, k), 20)}]
    for warps in (2, 4, 8):
        run = functools.partial(_knn_cuda, query, ref, k, warps=warps)
        vd, vi = run()
        check(torch.equal(vd, d) and torch.equal(vi, i), f"knn {name} warps={warps}: same result")
        rows.append({"warps": warps, **device_ms(run, 20)})
    return [{"shape": name, **r} for r in rows]


def gather_case(src: torch.Tensor, idx: torch.Tensor) -> dict:
    out = tgather.gather_points(src, idx)
    ref = tgather.gather_points_plain(src, idx)
    err = (out - ref).abs().max().item()
    check(torch.equal(out, ref),
          f"gather B={idx.shape[0]} M={idx.shape[1]} C={src.shape[2]}: bit-exact")
    b, _, c = src.shape
    m = idx.shape[1]
    rows = sum(int(torch.unique(idx[j]).numel()) for j in range(b))
    nbytes = b * m * 4 + rows * c * 4 + b * m * c * 4  # idx, the rows read, out
    bnd, by = bound_ms(nbytes, 0.0)
    index = idx.long()[..., None].expand(-1, -1, c)
    return {
        "shape": f"B={b} N={src.shape[1]} M={m} C={c}", "max_abs_err": err,
        "bound_ms": bnd, "bound_by": by,
        **kernel_times(lambda: tgather.gather_points(src, idx),
                       lambda: tgather.gather_points_plain(src, idx),
                       lambda: torch.gather(src, 1, index), 50, 50),
    }


def scatter_case(gen: torch.Generator, idx: torch.Tensor, n: int, c: int, what: str) -> dict:
    """``idx (B, S, K)``: a grouping's neighbour indices into ``n`` source
    rows; the incoming gradient is random, ``(B, S*K, c)``. The kernel adds
    each row's updates in ascending m from 0.0f, as ``index_add_`` does on
    the CPU: it must equal that to the bit."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1).contiguous()
    m = flat.shape[1]
    upd = torch.randn(b, m, c, device=idx.device, generator=gen)
    out = tgather.scatter_add_rows(upd, flat, n)
    again = tgather.scatter_add_rows(upd, flat, n)
    ref = tgather.scatter_add_rows_plain(upd, flat, n)
    torch.cuda.synchronize()
    name = f"B={b} N={n} M={m} C={c} ({what})"
    check(torch.equal(out, again), f"scatter_add {name}: two launches agree to the bit")
    loop = tgather.scatter_add_rows_plain(upd.cpu(), flat.cpu(), n)
    check(torch.equal(out.cpu(), loop),
          f"scatter_add {name}: equal to the plain version on the CPU to the bit "
          f"({int((out.cpu() != loop).sum())} elements differ)")
    # the plain version's float atomics add in an order of their own: the
    # rounding of a sum is bounded by its terms' magnitudes
    scale = tgather.scatter_add_rows_plain(upd.abs(), flat, n).max().item()
    err = (out - ref).abs().max().item()
    longest = int(tgather.scatter_add_rows_plain(torch.ones_like(upd[..., :1]), flat, n).max())
    check(err <= 1e-5 * max(scale, 1.0),
          f"scatter_add {name}: within 1e-5 x {scale:.3g} of plain (max {err:.3g}, "
          f"longest segment {longest})")
    nbytes = 4 * (upd.numel() + flat.numel() + out.numel())
    bnd, by = bound_ms(nbytes, float(upd.numel()))  # one add per update element
    rows = (flat.long() + n * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    upd2d = upd.reshape(b * m, c)
    return {
        "shape": name, "max_abs_err": err, "longest_segment": longest,
        "bound_ms": bnd, "bound_by": by,
        # library: index_add_ into fresh zeros, the flat int64 rows precomputed
        **kernel_times(lambda: tgather.scatter_add_rows(upd, flat, n),
                       lambda: tgather.scatter_add_rows_plain(upd, flat, n),
                       lambda: upd.new_zeros((b * n, c)).index_add_(0, rows, upd2d), 50, 20),
    }


def train_pyramid(frames: torch.Tensor) -> tuple:
    """Levels 1 and 2 ``(16, 2048, 3)``, ``(16, 1024, 3)`` of a batch-8 train
    step's pyramid, which stacks both frames of each pair on the batch axis:
    ``frames (8, 8192, 3)``, eight prepared scans, and each one's successor,
    give the real neighbour sets (and their skew) of the groupings."""
    both = torch.cat([frames, frames.roll(-1, 0)])
    l1 = tgather.gather_points(both, tfps.furthest_point_sample(both, 2048))
    return l1, tgather.gather_points(l1, tfps.furthest_point_sample(l1, 1024))


def scatter_cases(l1: torch.Tensor, l2: torch.Tensor) -> list:
    """The scatter-add at shapes of a full-width train step's backward:
    batch-8 groupings of one frame (the shapes earlier versions of this
    script timed, the first of them the kernels line's head), then the B=16
    level-2 grouping of the stacked pyramid, as the train step launches it."""
    gen = torch.Generator(device=l1.device).manual_seed(1)
    f1, f2 = l1[:TRAIN_BATCH], l2[:TRAIN_BATCH]
    return [
        scatter_case(gen, knn(f2, f1, 32)[1], 2048, 19, "level-2 SetConv grouping"),
        scatter_case(gen, knn(f1, f2, 8)[1], 1024, 67, "level-1 SetUpConv grouping"),
        scatter_case(gen, knn(f1, f1, 4)[1], 2048, 67, "level-1 cost-volume self grouping"),
        scatter_case(gen, knn(l2, l1, 32)[1], 2048, 19, "level-2 SetConv grouping, both frames"),
    ]


def folded_stack(gen: torch.Generator, cin: int, widths: tuple) -> tuple:
    """Folded ``(weights, biases)`` of a seeded ``PointMLP`` whose BatchNorm
    scale, bias and running statistics are perturbed, so the fold matters."""
    mlp = PointMLP(cin, widths, generator=gen)
    with torch.no_grad():
        for name, t in list(mlp.named_parameters()) + list(mlp.named_buffers()):
            if name.startswith("kernel"):
                continue
            noise = torch.randn(t.shape, generator=gen) * 0.3
            t.add_(noise.abs() if name.startswith("var") else noise)
    return mlp.cuda().folded()


def stack_macs(cin: int, wb: tuple) -> int:
    """Multiply-adds per row of a folded stack."""
    return sum(w.shape[0] * w.shape[1] for w in wb[0])


def stack_bytes(wb: tuple) -> int:
    return sum(4 * t.numel() for part in wb for t in part)


def mlp_input(gen: torch.Generator, s: int, k: int, cin: int, reach: float = 0.0) -> torch.Tensor:
    """``(1, s, k, cin)`` normal, or with ``reach`` the first pyramid level's
    input at KITTI scale: ``[q - p, q]`` (``models/pointnet2.py``) with
    centres ``p`` uniform in direction at 2 m to ``reach`` m and neighbours
    ``q`` within about a metre."""
    if not reach:
        return torch.randn(1, s, k, cin, generator=gen).cuda()
    direction = torch.nn.functional.normalize(torch.randn(1, s, 1, 3, generator=gen), dim=-1)
    p = direction * (2.0 + (reach - 2.0) * torch.rand(1, s, 1, 1, generator=gen))
    q = p + 0.5 * torch.randn(1, s, k, 3, generator=gen)
    return torch.cat([q - p, q], dim=-1).cuda()


def mlp_case(gen: torch.Generator, s: int, k: int, cin: int, widths: tuple,
             reach: float = 0.0) -> dict:
    """The kernel multiplies in 3xTF32 on the tensor cores (three TF32
    products for each fp32 one): ``bound_ms`` counts those at 495 TFLOP/s,
    ``bound_fp32_ms`` the products in fp32 on the CUDA cores at 67."""
    x = mlp_input(gen, s, k, cin, reach)
    wb = folded_stack(gen, cin, widths)
    out = ops.mlp_maxpool(x, wb)
    ref = mlp_maxpool_plain(x, wb)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    name = f"({s},{k},{cin})->{widths}".replace(" ", "") + (f" at {reach:g} m" if reach else "")
    check(torch.allclose(out, ref, atol=3e-5, rtol=1e-4),
          f"mlp_maxpool {name}: within atol 3e-5 rtol 1e-4 of plain (max {err:.3g})")
    nbytes = 4 * x.numel() + stack_bytes(wb) + 4 * out.numel()
    macs = s * k * stack_macs(cin, wb)
    bnd, by = bound_ms(nbytes, 6.0 * macs, TF32_FLOPS)
    return {
        "shape": name, "max_abs_err": err,
        "bound_ms": bnd, "bound_by": by, "bound_fp32_ms": bound_ms(nbytes, 2.0 * macs)[0],
        **kernel_times(lambda: ops.mlp_maxpool(x, wb), lambda: mlp_maxpool_plain(x, wb),
                       None, 50, 20),
    }


def mlp_variants(gen: torch.Generator) -> list:
    """The MLP kernel at every path shape with other tiles than the wrapper's
    (``ops/tf32x3.py::mlp_tile``): 16 to 128 rows at once (as the widest
    layer allows; the fewest whole centres that fill them), and blocks that
    walk 2 or 4 such tiles; each ``torch.equal`` to the wrapper's choice (a
    row's products do not depend on the tile) and timed. The first entry of
    each shape is the wrapper's own choice."""
    rows_out = []
    for s, k, cin, widths in MLP_PATH_SHAPES:
        x = torch.randn(1, s, k, cin, generator=gen).cuda()
        wb = folded_stack(gen, cin, widths)
        ref = ops.mlp_maxpool(x, wb)
        own = mlp_tile(s, k, max(widths), sm_count(x.device))
        name = f"({s},{k},{cin})->{widths}".replace(" ", "")
        rows = [{"block_centres": own[0], "tile_rows": own[1], "own": True,
                 **device_ms(lambda: ops.mlp_maxpool(x, wb), 50)}]
        limit = max_tile_rows(max(widths))
        for tile_rows in (16, 32, 64, 128):
            if tile_rows > limit or (k > tile_rows and tile_rows < limit):
                continue  # too wide, or a centre split where a longer tile would hold more
            for walk in (1, 2, 4):
                tile = (max(1, tile_rows // k) * walk, tile_rows)
                if tile == own:
                    continue
                run = functools.partial(mlp_mod._mlp_maxpool_cuda, x, wb, tile=tile)
                check(torch.equal(run(), ref), f"mlp_maxpool {name} tile={tile}: same result")
                rows.append({"block_centres": tile[0], "tile_rows": tile[1], "own": False,
                             **device_ms(run, 50)})
        rows_out += [{"shape": name, **r} for r in rows]
    return rows_out


def aggregate_case(gen: torch.Generator, s: int, k: int, cc: int, cg: int, cross: bool,
                   reach: float = 0.0) -> dict:
    """Cross stage: emb stack (128, 64, 64) over [enc, cf, gf]; self stage: no
    emb stack, centre features in the attention. D = 64 in both. Centres
    normal with 10 m deviation, or with ``reach`` at KITTI scale: uniform in
    direction, at 2 m to ``reach`` m; neighbours within about a metre. The
    kernel runs on the tensor cores in 3xTF32 (three TF32 products for each
    fp32 one): ``bound_ms`` counts those at 495 TFLOP/s, ``bound_fp32_ms``
    the products in fp32 on the CUDA cores at 67."""
    d = 64
    if reach:
        direction = torch.nn.functional.normalize(torch.randn(1, s, 3, generator=gen), dim=-1)
        cxyz = (direction * (2.0 + (reach - 2.0) * torch.rand(1, s, 1, generator=gen))).cuda()
    else:
        cxyz = (torch.randn(1, s, 3, generator=gen) * 10.0).cuda()
    gxyz = cxyz[:, :, None, :] + torch.randn(1, s, k, 3, generator=gen).cuda()
    cfeat = torch.randn(1, s, cc, generator=gen).cuda()
    gfeat = torch.randn(1, s, k, cg, generator=gen).cuda()
    enc_wb = folded_stack(gen, 10, (d,))
    emb_wb = folded_stack(gen, 10 + cc + cg, (128, 64, d)) if cross else None
    att_wb = folded_stack(gen, d + (0 if cross else cc) + d, (128, d))
    args = (cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, not cross)
    out = ops.attentive_aggregate(*args)
    ref = attentive_aggregate_plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    name = f"{'cross' if cross else 'self'} ({s},{k},{cc},{cg}){f' at {reach:g} m' if reach else ''}"
    check(torch.allclose(out, ref, atol=5e-5, rtol=1e-4),
          f"attentive_aggregate {name}: within atol 5e-5 rtol 1e-4 of plain (max {err:.3g})")
    stacks = [wb for wb in (enc_wb, emb_wb, att_wb) if wb is not None]
    nbytes = 4 * sum(t.numel() for t in (cxyz, gxyz, cfeat, gfeat, out)) + sum(
        stack_bytes(wb) for wb in stacks)
    macs = sum(stack_macs(wb[0][0].shape[0], wb) for wb in stacks)
    bnd, by = bound_ms(nbytes, 6.0 * s * k * macs, TF32_FLOPS)
    return {
        "shape": name, "max_abs_err": err,
        "bound_ms": bnd, "bound_by": by, "bound_fp32_ms": bound_ms(nbytes, 2.0 * s * k * macs)[0],
        **kernel_times(lambda: ops.attentive_aggregate(*args),
                       lambda: attentive_aggregate_plain(*args), None, 50, 20),
    }


def fused_kernel_cases() -> dict:
    """The two fused kernels at the shapes the full-width main path (B=1)
    gives them (the shapes and stack widths ``tools/time_point_kernels.py
    --ops attentive_aggregate,mlp_maxpool`` records from a forward), and the
    aggregate's widest at KITTI's reach; no single PyTorch call computes
    either, so no library time."""
    gen = torch.Generator().manual_seed(0)
    mlp = [mlp_case(gen, *shape) for shape in MLP_PATH_SHAPES]
    mlp.append(mlp_case(gen, 2048, 32, 6, (8, 8, 16), reach=80.0))  # level 1 at KITTI's reach
    aggregate = [
        aggregate_case(gen, 256, 32, 64, 64, cross=True),  # level-3 cost volume
        aggregate_case(gen, 256, 4, 64, 64, cross=False),
        aggregate_case(gen, 256, 6, 64, 64, cross=True),  # re-embedding volumes
        aggregate_case(gen, 1024, 6, 32, 32, cross=True),
        aggregate_case(gen, 1024, 4, 32, 64, cross=False),
        aggregate_case(gen, 2048, 6, 16, 16, cross=True),
        aggregate_case(gen, 2048, 4, 16, 64, cross=False),
        aggregate_case(gen, 2048, 6, 16, 16, cross=True, reach=80.0),  # KITTI's reach
    ]
    return {"mlp_maxpool": mlp, "attentive_aggregate": aggregate}


def kernel_phase(scan: torch.Tensor, scan2: torch.Tensor, frames: torch.Tensor) -> dict:
    """``scan``/``scan2``: two prepared full-width frames ``(1, 8192, 3)``;
    ``frames``: eight of them, for the train step's gather and scatter-add
    shapes (batch 8, and 16 where the pyramid stacks both frames). FPS and
    kNN at every shape the main path gives them, and with both frames stacked
    on the batch axis as the siamese pyramid launches them."""
    cases = {"fps": [], "knn": [], "gather": []}
    both = torch.cat([scan, scan2])  # (2, 8192, 3): the pyramid's paired launch
    levels = [both]
    for npoint in (2048, 1024, 256, 64):
        cases["fps"].append(fps_case(levels[-1][:1], npoint))
        levels.append(tgather.gather_points(
            levels[-1], tfps.furthest_point_sample(levels[-1], npoint)))
    for one, (level, npoint) in zip(cases["fps"], ((levels[0], 2048), (levels[1], 1024))):
        paired = fps_case(level, npoint)  # both frames in one launch
        cases["fps"].append(paired)
        check(paired["ms"] <= 1.1 * one["ms"], f"fps {paired['shape']}: the paired launch takes "
              f"{paired['ms']:.3f} ms, at most 1.1 x the {one['ms']:.3f} ms of one frame")
    (l0, l1, l2, l3, l4), (_, l1b, l2b, l3b, _) = ([lv[f:f + 1] for lv in levels] for f in (0, 1))
    cases["knn"] += [
        knn_case(l1, l0, 32, "level-1 SetConv"),
        knn_case(l1, l1b, 6, "level-1 cost volume"),
        knn_case(l2, l1, 32, "level-2 SetConv"),
        knn_case(levels[1], levels[0], 32, "level-1 SetConv, both frames"),
        knn_case(levels[2], levels[1], 32, "level-2 SetConv, both frames"),
        knn_case(l3, l2, 16, "level-3 SetConv"),
        knn_case(l4, l3, 16, "level-4 SetConv"),
        knn_case(l3, l3b, 32, "level-3 cost volume"),
        knn_case(l3, l3, 4, "level-3 cost volume, self"),
        knn_case(l3, l4, 8, "level-3 SetUpConv"),
        knn_case(l2, l3, 8, "level-2 SetUpConv"),
        knn_case(l1, l2, 8, "level-1 SetUpConv"),
        knn_case(l3, l3b, 6, "level-3 re-embedding"),
        knn_case(l2, l2b, 6, "level-2 cost volume"),
        knn_case(l2, l2, 4, "level-2 cost volume, self"),
        knn_case(l1, l1, 4, "level-1 cost volume, self"),
    ]
    # many exact ties: an integer grid, and every reference point twice
    grid = torch.stack(torch.meshgrid(*[torch.arange(13.0, device=scan.device)] * 3,
                                      indexing="ij"), -1).reshape(1, -1, 3)
    cases["knn"].append(knn_case(grid, grid, 32, "integer grid"))
    cases["knn"].append(knn_case(l2, torch.cat([l1, l1], dim=1), 16, "duplicated points"))
    variants = {
        "fps": (fps_variants(l0, 2048) + fps_variants(l1, 1024) + fps_variants(l2, 256)
                + fps_variants(l3, 64)),
        "knn": knn_variants(l1, l0, 32) + knn_variants(l2, l1, 32) + knn_variants(l1, l1b, 6),
        "mlp_maxpool": mlp_variants(torch.Generator().manual_seed(1)),
    }
    # the level-1 index at B=1 first (the kernels line's head, as in earlier
    # versions of this script), then the train step's widest groupings
    _, nn_idx = knn(l1, l0, 32)
    flat = nn_idx.reshape(1, -1).contiguous()  # M = 2048 * 32 = 65,536 rows
    cases["gather"].append(gather_case(scan, flat))
    gen = torch.Generator(device=scan.device).manual_seed(0)
    wide = torch.randn(1, 8192, 67, device=scan.device, generator=gen)
    cases["gather"].append(gather_case(wide, flat))
    t1, t2 = train_pyramid(frames)
    up = knn(t1[:TRAIN_BATCH], t2[:TRAIN_BATCH], 8)[1].reshape(TRAIN_BATCH, -1).contiguous()
    cases["gather"].append(gather_case(
        torch.randn(TRAIN_BATCH, 1024, 67, device=scan.device, generator=gen), up))
    grouping = knn(t2, t1, 32)[1].reshape(2 * TRAIN_BATCH, -1).contiguous()
    cases["gather"].append(gather_case(
        torch.randn(2 * TRAIN_BATCH, 2048, 19, device=scan.device, generator=gen), grouping))
    cases["scatter_add"] = scatter_cases(t1, t2)
    cases.update(fused_kernel_cases())
    return cases, variants


# ---------------------------------------------------------------------------
# Phase 3: the small config, card against CPU
# ---------------------------------------------------------------------------


def small_config_phase(scans: np.ndarray) -> dict:
    cpu = PWCLONet(SMALL, seed=1, device="cpu")
    gpu = PWCLONet(SMALL, seed=1, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    pick = [rng.choice(scans.shape[1], 256, replace=False) for _ in range(4)]
    x1 = np.stack([scans[1][pick[0]], scans[2][pick[1]]])
    x2 = np.stack([scans[0][pick[2]], scans[1][pick[3]]])
    with torch.inference_mode():
        ref, ref_aux = cpu(torch.from_numpy(x1), torch.from_numpy(x2))
        out, aux = gpu(torch.from_numpy(x1).cuda(), torch.from_numpy(x2).cuda())
    err = (out.cpu() - ref).abs().max().item()
    ok = torch.allclose(out.cpu(), ref, atol=1e-4, rtol=1e-3) and torch.allclose(
        aux["embedding_mask"].cpu(), ref_aux["embedding_mask"], atol=1e-4, rtol=1e-3)
    check(ok, f"small config: card vs CPU pose params within atol 1e-4 rtol 1e-3 (max {err:.3g})")

    fused = PWCLONet(dataclasses.replace(SMALL, fused_eval=True), seed=2, device="cuda")
    fused.load_state_dict(cpu.state_dict())
    with torch.inference_mode():
        f_out, f_aux = fused(torch.from_numpy(x1).cuda(), torch.from_numpy(x2).cuda())
    fused_err = (f_out - out).abs().max().item()
    ok = torch.allclose(f_out, out, atol=1e-4, rtol=1e-3) and torch.allclose(
        f_aux["embedding_mask"], aux["embedding_mask"], atol=1e-4, rtol=1e-3)
    check(ok, "small config: fused vs unfused on the card within atol 1e-4 rtol 1e-3 "
          f"(max {fused_err:.3g})")
    return {"small_config_max_abs_err": err, "small_config_fused_vs_unfused_max_abs_err": fused_err}


def _dropout_off(model) -> None:
    for m in model.modules():
        if isinstance(m, PoseCalculator):
            m.dropout_rate = 0.0


def small_train_phase(scans: np.ndarray) -> dict:
    """One train-mode forward + backward of the small config on the card
    (gather and scatter-add kernels) against the CPU plain path (PyTorch's
    own autograd of ``torch.gather``), same state, dropout off."""
    cfg = tstate.TrainConfig(model=SMALL, total_steps=100)
    cpu = tstate.create_train_state(cfg, seed=1, device="cpu")
    gpu = tstate.create_train_state(cfg, seed=1, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    _dropout_off(cpu.model)
    _dropout_off(gpu.model)
    rng = np.random.default_rng(1)
    pick = [rng.choice(scans.shape[1], 256, replace=False) for _ in range(4)]
    batch = {
        "xyz1": np.stack([scans[1][pick[0]], scans[2][pick[1]]]),
        "xyz2": np.stack([scans[0][pick[2]], scans[1][pick[3]]]),
        "gt_params": np.array([[1.0, 0.02, 0.0, 1.0, 0.0, 0.0, 0.0]] * 2, np.float32),
    }
    ref_loss, _, ref_grads = tstate.loss_and_grads(cfg, cpu, batch)
    loss, _, grads = tstate.loss_and_grads(cfg, gpu, batch)
    torch.cuda.synchronize()
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_err <= 1e-5, f"small config train step: card vs CPU loss within rtol 1e-5 "
          f"({loss.item():.6f} vs {ref_loss.item():.6f})")
    worst = 0.0
    for name, ref in ref_grads.items():
        gap = (grads[name].cpu() - ref).abs().max().item()
        worst = max(worst, gap / (1e-4 + 1e-3 * ref.abs().max().item()))
    check(worst <= 1.0, "small config train step: every gradient leaf within atol 1e-4 + 1e-3 of "
          f"its largest magnitude (worst at {worst:.3g} of the bar, {len(ref_grads)} leaves)")
    return {"small_train_loss_rel_err": loss_err, "small_train_grad_worst_share_of_bar": worst}


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


def is_se3(poses: np.ndarray, tol: float = 1e-4) -> bool:
    rot = poses[:, :3, :3]
    ortho = np.abs(np.einsum("tji,tjk->tik", rot, rot) - np.eye(3)).max()
    det = np.abs(np.linalg.det(rot) - 1.0).max()
    bottom = np.abs(poses[:, 3] - np.array([0, 0, 0, 1.0])).max()
    return bool(np.isfinite(poses).all() and ortho < tol and det < tol and bottom == 0)


def main_path_phase(odo: PWCLONetOdometry, scans: np.ndarray) -> dict:
    n_frames = scans.shape[0]
    fused = odo.config.model.fused_eval
    label = "fused" if fused else "unfused"
    _cuda.reset_launch_counts()
    odo.init()
    for scan in scans:
        odo.process_next_frame(scan)
    per_frame = odo.absolute_poses()
    odo.init()
    batched = odo.process_sequence(scans)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    forwards = (n_frames - 1) + 1  # T-1 pairs one by one, then one batched forward
    for name, per_fwd in LAUNCHES_PER_FORWARD[fused].items():
        if per_fwd:
            check(counts[name] > 0,
                  f"{label} main path launched the {name} kernel ({counts[name]} times)")
        check(counts[name] == per_fwd * forwards,
              f"{label} {name}: {per_fwd} launches per forward x {forwards} forwards")
    check(per_frame.shape == batched.shape == (n_frames, 4, 4), f"{label} pose shapes (T, 4, 4)")
    check(is_se3(per_frame) and is_se3(batched), f"{label} poses are finite SE(3)")
    # reported, not held to a bound: the two batchings round the matmuls
    # differently, and the kNN on warped points (|q|^2 + |r|^2 - 2 q.r at
    # ranges of tens of metres) turns such last-bit differences into
    # neighbour swaps near ties, which random weights then amplify
    gap = float(np.abs(per_frame - batched).max())
    log(f"{label} per-frame vs batched pose chains: max gap {gap:.3g}")
    return {"launches": counts, "forwards": forwards, "per_frame_vs_batched_max_gap": gap,
            "poses": per_frame}


def bfloat16_forward(x1: torch.Tensor, x2: torch.Tensor) -> None:
    net = PWCLONet(PWCLONetConfig(compute_dtype="bfloat16"), seed=0)
    with torch.inference_mode():
        params, _ = net(x1, x2)
    torch.cuda.synchronize()
    quat_norm = torch.linalg.norm(params[..., 3:], dim=-1)
    check(params.shape == (1, 4, 7) and params.dtype == torch.float32
          and bool(torch.isfinite(params).all())
          and bool(torch.allclose(quat_norm, torch.ones_like(quat_norm), atol=1e-5)),
          "bfloat16 full-width forward: finite float32 poses with unit quaternions")


# ---------------------------------------------------------------------------
# Phase 5: end-to-end times
# ---------------------------------------------------------------------------


def timing_phase(odos: dict, scans: np.ndarray) -> dict:
    """``odos``: ``{"unfused": odometry, "fused": odometry}``. The B=1 forwards
    are timed in turns (unfused, fused, fused, unfused) so that both see the
    same card and host; every other time is taken per configuration."""
    first = next(iter(odos.values()))
    prepared = np.stack([first._prepare(s) for s in scans])
    x1 = torch.from_numpy(prepared[1:2]).cuda()
    x2 = torch.from_numpy(prepared[0:1]).cuda()
    xb1 = torch.from_numpy(prepared[1:]).cuda()
    xb2 = torch.from_numpy(prepared[:-1]).cuda()
    pairs = scans.shape[0] - 1
    fwd_ms = {label: [] for label in odos}
    with torch.inference_mode():
        for label in ("unfused", "fused", "fused", "unfused"):
            model = odos[label].model
            fwd_ms[label].append(time_ms(lambda: model(x1, x2), reps=10))
    out = {}
    for label, odo in odos.items():
        with torch.inference_mode():
            fwd_batch_ms = time_ms(lambda: odo.model(xb1, xb2), reps=5)
        seq_s = []
        for _ in range(3):
            odo.init()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            odo.process_sequence(scans)  # ends in a device-to-host copy
            seq_s.append(time.perf_counter() - t0)
        frame_s = []
        odo.init()
        odo.process_next_frame(scans[0])
        for scan in scans[1:]:
            t0 = time.perf_counter()
            odo.process_next_frame(scan)
            frame_s.append(time.perf_counter() - t0)
        out[label] = {
            "forward_ms_b1": statistics.median(fwd_ms[label]),
            "forward_ms_b1_runs": fwd_ms[label],
            f"forward_ms_b{pairs}": fwd_batch_ms,
            "process_next_frame_ms_median": 1e3 * statistics.median(frame_s),
            "process_sequence_s_runs": seq_s,
            "process_sequence_pairs_per_s": pairs / statistics.median(seq_s),
            "pairs": pairs,
        }
    return out


def profile_forward(label: str, odo: PWCLONetOdometry, scans: np.ndarray) -> dict:
    """Profile one full-width B=1 forward: the table on stderr; returns the
    device time by kernel, the count of device launches and the share of the
    span from the first kernel's start to the last one's end in which no
    kernel ran (with the profiler's own host overhead in it)."""
    prepared = np.stack([odo._prepare(s) for s in scans[:2]])
    x1 = torch.from_numpy(prepared[1:2]).cuda()
    x2 = torch.from_numpy(prepared[0:1]).cuda()

    def forward():
        with torch.inference_mode():
            odo.model(x1, x2)

    prof, device = profile_device_events(forward)
    print(f"profile of one {label} forward", file=sys.stderr)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), file=sys.stderr)
    seen = {name: sum(1 for e in device if f"{name}_kernel" in e.name)
            for name in ("fps", "knn", "gather")}
    expected = {name: LAUNCHES_PER_FORWARD[False][name] for name in seen}
    check(seen == expected, f"profiler saw every FPS, kNN and gather launch of the {label} forward")
    return summarize_device_events(device)


# ---------------------------------------------------------------------------
# Phase 5: training at full width, and the learning recipe
# ---------------------------------------------------------------------------


def train_path_phase(scans: np.ndarray, log_dir: str) -> dict:
    """``PWCLONetTrainer`` on the card at full width: one epoch of
    ``TRAIN_STEPS`` steps at batch ``TRAIN_BATCH``."""
    cli = train_net_torch.Config(batch_size=TRAIN_BATCH, num_points=8192,
                                 synthetic_batches=TRAIN_STEPS, log_dir=log_dir)
    train_fn, _ = train_net_torch.make_batch_fns(cli)
    cfg = tstate.TrainConfig(model=PWCLONetConfig(fused_eval=True), total_steps=1000)
    trainer = PWCLONetTrainer(TrainerConfig(train=cfg, log_dir=log_dir, steps_per_dispatch=3))
    state = trainer.state
    check(all(p.is_cuda for p in state.trainable().values()),
          "the trainer's model and loss parameters lie on the card by default")
    _cuda.reset_launch_counts()
    mean_loss = trainer.train_epoch(train_fn())
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    for name, per_step in LAUNCHES_PER_TRAIN_STEP.items():
        if per_step:
            check(counts[name] > 0,
                  f"training path launched the {name} kernel ({counts[name]} times)")
        check(counts[name] == per_step * TRAIN_STEPS,
              f"training {name}: {per_step} launches per step x {TRAIN_STEPS} steps")
    logs = trainer.last_epoch_logs
    check(len(logs["loss"]) == TRAIN_STEPS and bool(np.isfinite(logs["loss"]).all())
          and math.isfinite(mean_loss), f"every train loss finite ({logs['loss'].tolist()})")
    check(not logs["skipped_nonfinite"].any() and int(state.optimizer.count) == TRAIN_STEPS,
          "no step skipped: the optimizer applied every update")
    check(bool(np.isfinite(logs["grad_norm"]).all()) and bool((logs["grad_norm"] > 0).all()),
          f"gradient norms finite and non-zero ({logs['grad_norm'].tolist()})")
    check(state.step == TRAIN_STEPS, f"the step counter stands at {TRAIN_STEPS}")

    # the same step from the same state and generator, twice
    batch = next(iter(train_fn()))
    runs = []
    for _ in range(2):
        gen_state = state.generator.get_state()
        _, _, grads = tstate.loss_and_grads(cfg, state, batch)
        discard_batch_stats(state.model)
        state.generator.set_state(gen_state)
        runs.append(grads)
    torch.cuda.synchronize()
    check(all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]),
          f"two identical train steps give bit-identical gradients ({len(runs[0])} leaves)")

    path = trainer.save_checkpoint("final")
    odo = PWCLONetOdometry(path, DeepOdometryConfig(model=PWCLONetConfig(fused_eval=True)))
    check(all(torch.equal(v, odo.model.state_dict()[k])
              for k, v in trainer.model.state_dict().items()),
          "the checkpoint's weights and statistics are the odometry's")
    odo.init()
    for scan in scans[:3]:
        odo.process_next_frame(scan)
    check(is_se3(odo.absolute_poses()), "trained checkpoint in the fused odometry: finite SE(3) poses")
    return {"launches": counts, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
            "losses": logs["loss"].tolist(), "grad_norms": logs["grad_norm"].tolist(),
            "trainer": trainer, "batches": list(train_fn())}


def learning_phase() -> dict:
    """The fast-lane recipe on the card, held as on the CPU
    (``tests/test_torch_learning.py``)."""
    t0 = time.perf_counter()
    r = run_fast_lane_recipe(device="cuda", epochs=40)
    r["seconds"] = time.perf_counter() - t0
    log(f"fast-lane recipe on the card: ratio {r['ratio']:.4f}, ATEs {r['ates']}, untrained "
        f"{r['untrained_ate']:.4f}, losses {r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}, "
        f"{r['steps']} steps in {r['seconds']:.1f} s")
    check(all(math.isfinite(v) for v in r["losses"]) and r["losses"][-1] < r["losses"][0],
          "learning recipe: losses finite and falling")
    check(r["finite"], "learning recipe: finite poses on the held-out worlds")
    check(r["ratio"] < 0.40, f"learning recipe: relative-pose RMSE / travel {r['ratio']:.4f} < 0.40")
    check(r["ates"][0] < 0.6 * r["untrained_ate"],
          f"learning recipe: trained ATE {r['ates'][0]:.4f} < 0.6 x untrained {r['untrained_ate']:.4f}")
    return r


def profile_device_events(fn):
    """Run ``fn()`` under the profiler; returns ``(prof, device events)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the first profile of a process can lose its earliest device events
    # while the tracer starts up: profile twice, keep the second
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return prof, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def summarize_device_events(device: list) -> dict:
    """Device time by kernel, launches, and the share of the span from the
    first kernel's start to the last one's end in which no kernel ran (with
    the profiler's own host overhead in it)."""
    by_name: dict = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    span_ms = (max(e.time_range.end for e in device)
               - min(e.time_range.start for e in device)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # a scatter-add is four kernels: scatter_{rank,scan,fill,sum}_kernel
    ours = {name: sum(ms for k, (ms, _) in by_name.items()
                      if ("scatter_" in k and "_kernel" in k and "gather" not in k
                          if name == "scatter_add" else f"{name}_kernel" in k))
            for name in KERNELS}
    return {
        "device_ms": busy_ms, "span_ms": span_ms, "idle_share": 1.0 - busy_ms / span_ms,
        "device_launches": len(device), "device_ms_by_port_kernel": ours,
        "device_ms_everything_else": busy_ms - sum(ours.values()),
        "top_kernels": [{"name": k[:80], "ms": ms, "launches": n} for k, (ms, n) in top],
    }


def train_timing_phase(train: dict, show_table: bool) -> dict:
    """Times of the full-width train step at batch ``TRAIN_BATCH``: CUDA
    events around each of six whole steps; forward (with the loss) and
    backward apart over three more; one profiled step for the device's
    launches, time by kernel and idle share; peak memory over all of it."""
    trainer, batches = train["trainer"], train["batches"]
    cfg, state = trainer.config.train, trainer.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tstate.train_step(cfg, state, batches[0])  # warm
    step_ms = []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        tstate.train_step(cfg, state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    fwd_ms, bwd_ms = [], []
    for batch in batches[:3]:
        dev = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        pred, _ = state.model(dev["xyz1"], dev["xyz2"], train=True,
                              bn_momentum=tstate.bn_momentum(cfg, state.step),
                              generator=state.generator)
        loss, _ = pwclonet_loss(state.loss_params, pred, dev["gt_params"], cfg.loss)
        marks[1].record()
        torch.autograd.grad(loss, list(state.trainable().values()))
        marks[2].record()
        torch.cuda.synchronize()
        discard_batch_stats(state.model)
        fwd_ms.append(marks[0].elapsed_time(marks[1]))
        bwd_ms.append(marks[1].elapsed_time(marks[2]))
    peak = torch.cuda.max_memory_allocated()
    prof, device = profile_device_events(lambda: tstate.train_step(cfg, state, batches[0]))
    check(len(device) > 0, "the profiler saw the train step's device events")
    if show_table:
        print("profile of one full-width train step", file=sys.stderr)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30), file=sys.stderr)
    step = statistics.median(step_ms)
    return {
        "train_step_ms": step, "train_step_ms_runs": step_ms,
        "train_pairs_per_s": TRAIN_BATCH / step * 1e3,
        "train_forward_ms": statistics.median(fwd_ms), "train_backward_ms": statistics.median(bwd_ms),
        "train_peak_memory_bytes": peak, "train_step_profile": summarize_device_events(device),
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one full-width forward of each configuration")
    parser.add_argument("--kernels", action="store_true",
                        help="stop after phase 2: build, each kernel against its plain version, "
                             "and the FPS, kNN and MLP launch variants; prints no ok line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products, as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("phase 1: build the kernels")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    log(f"built {lib_path.name} in {build_s:.1f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    log(f"generating a {N_FRAMES}-frame corridor sequence at 8192 points")
    t0 = time.perf_counter()
    scans, _gt = generate_sequence(SyntheticSequenceConfig(n_frames=N_FRAMES, seed=0))
    gen_s = time.perf_counter() - t0
    # both on the card by default; the same seed gives both the same weights
    odos = {
        "unfused": PWCLONetOdometry(None, DeepOdometryConfig(), seed=0),
        "fused": PWCLONetOdometry(
            None, DeepOdometryConfig(model=PWCLONetConfig(fused_eval=True)), seed=0),
    }
    check(all(p.is_cuda for odo in odos.values() for p in odo.model.parameters()),
          "the odometry's model lies on the card by default")
    frames = torch.from_numpy(
        np.stack([odos["fused"]._prepare(s) for s in scans[:TRAIN_BATCH]])).cuda()
    scan0, scan1 = frames[0:1], frames[1:2]

    log("phase 2: kernels against their plain versions")
    cases, variants = kernel_phase(scan0, scan1, frames)
    if args.kernels:
        print(card_line())
        print(json.dumps({"cases": cases}))
        print(json.dumps({"variants": variants}))
        return 0

    log("phase 3: small config, card against CPU, fused against unfused, one train step")
    small = {**small_config_phase(scans), **small_train_phase(scans)}

    log("phase 4: the main path at full width, fused and unfused")
    main = {
        "fused": main_path_phase(odos["fused"], scans),
        "unfused": main_path_phase(odos["unfused"], scans[:N_FRAMES_UNFUSED]),
    }
    poses = {label: m.pop("poses") for label, m in main.items()}
    # reported, not held: last-bit differences swap kNN neighbours on the
    # warped points, and random weights amplify that (see main_path_phase)
    fused_gap = float(np.abs(poses["fused"][:N_FRAMES_UNFUSED] - poses["unfused"]).max())
    log(f"fused vs unfused pose chains over {N_FRAMES_UNFUSED} frames: max gap {fused_gap:.3g}")
    bfloat16_forward(scan1, scan0)

    log("phase 5: training at full width, then the learning recipe")
    with tempfile.TemporaryDirectory() as log_dir:
        train = train_path_phase(scans, log_dir)
    learning = learning_phase()

    log("phase 6: times")
    train_times = train_timing_phase(train, show_table=args.profile)
    del train["trainer"], train["batches"]
    times = timing_phase(odos, scans)
    profiles = {}
    if args.profile:
        profiles = {label: profile_forward(label, odo, scans) for label, odo in odos.items()}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        head = cases[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # of the path that runs the kernel: the fused eval drive, or the
            # training drive for the gather's backward
            "launches": (train if name == "scatter_add" else main["fused"])["launches"][name],
            "launches_unfused_path": main["unfused"]["launches"][name],
            "launches_train_path": train["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **({"chain_bound_ms": head["chain_bound_ms"]} if "chain_bound_ms" in head else {}),
            "shape": head["shape"], "cases": cases[name],
        })
    width = "8192 points, reference channel plan, float32, seeded random weights"
    metrics = {
        "configs": {
            "fused": f"PWCLONetConfig(fused_eval=True) full width: {width}",
            "unfused": f"PWCLONetConfig() full width: {width}",
            "train": f"PWCLONetTrainer, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, full width: "
                     "8192 points, reference channel plan, float32, random-cloud batches",
        },
        "build_s": build_s, "sequence_gen_s": gen_s, **small,
        "fused_vs_unfused_max_pose_gap": fused_gap,
        **{label: {**main[label], **times[label]} for label in odos},
        "train": {**train, **train_times}, "learning_recipe": learning,
        "profile": profiles, "total_s": time.perf_counter() - t_start,
    }
    print(card_line())
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"kernels": kernels}))
    finite = list(small.values())
    for t in times.values():
        finite += [t["forward_ms_b1"], t["process_sequence_pairs_per_s"]]
    finite += [train_times[key] for key in ("train_step_ms", "train_forward_ms",
                                            "train_backward_ms", "train_pairs_per_s")]
    finite += [k[key] for k in kernels for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")]
    check(all(math.isfinite(v) for v in finite), "every reported result is finite")
    check(len(kernels) == 6 and all(k["launches"] > 0 for k in kernels),
          "six kernels, each launched on its main path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
