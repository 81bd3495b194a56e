#!/usr/bin/env python3
"""Run the PyTorch port of PWCLO-Net odometry on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

from the root of the repository, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each of which must pass:

1. build the hand-written kernels of ``pwclonet_pylidarslam_torch/csrc``
   with ``nvcc`` for ``sm_90a``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the full-width main path gives it (B=1): FPS indices identical,
   kNN distances within 1e-5 and neighbour sets equal except where two
   distances tie within 1e-5, gather bit-exact;
3. run the small config (256 points) on the card and on the CPU with the
   same seeded weights and inputs: pose params within atol 1e-4 / rtol 1e-3;
4. drive the main path at full width (the default ``PWCLONetConfig``: 8192
   points, the reference channel plan, float32, seeded random weights) over
   a corridor sequence from the port's own generator: ``process_next_frame``
   over every frame, then ``process_sequence`` over the same frames. The
   launch counters are zeroed just before and read just after; every kernel
   must have launched, and exactly its count per forward times the forwards;
   the poses must be finite SE(3);
5. time the forward at B=1, ``process_sequence``, and each kernel beside its
   plain version, one PyTorch library call where one computes the same
   function, and its bound (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, the H100 SXM's published peaks).

Prints the card's name and power limit, a ``{"metrics": ...}`` line, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if CUDA is unavailable or any check
fails. ``--profile`` adds a profiler table of one full-width forward on
stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
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
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig  # noqa: E402
from pwclonet_pylidarslam_torch.ops import _cuda  # noqa: E402
from pwclonet_pylidarslam_torch.ops import fps as tfps  # noqa: E402
from pwclonet_pylidarslam_torch.ops import gather as tgather  # noqa: E402
from pwclonet_pylidarslam_torch.ops.knn import knn, knn_plain, pairwise_sqdist  # noqa: E402
from pwclonet_pylidarslam_torch.slam.deep_odometry import (  # noqa: E402
    DeepOdometryConfig,
    PWCLONetOdometry,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores, published
# launches of each kernel per forward pair, read off models/pwclonet.py:
# FPS: 4 pyramid SetConvs x 2 frames + the flow-embedding SetConv;
# kNN: 8 + 1 SetConv, 2 per cost volume x 4, 2 SetUpConvs x 3 levels;
# gather: 2 per SetConv x 9, 2 per cost volume x 4, 1 per SetUpConv x 6.
LAUNCHES_PER_FORWARD = {"fps": 9, "knn": 23, "gather": 32}
KERNELS = {
    "fps": ("pwclonet_pylidarslam_torch/csrc/fps.cu",
            "pwclonet_pylidarslam_tpu/ops/pallas/fps_kernel.py:116"),
    "knn": ("pwclonet_pylidarslam_torch/csrc/knn.cu",
            "pwclonet_pylidarslam_tpu/ops/pallas/knn_kernel.py:103"),
    "gather": ("pwclonet_pylidarslam_torch/csrc/gather.cu",
               "pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py:58"),
}
N_FRAMES = 10  # corridor sequence: 9 pairs one by one, then 9 in one batch
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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------


def fps_case(points: torch.Tensor, npoint: int) -> dict:
    out = tfps.furthest_point_sample(points, npoint)
    ref = tfps.furthest_point_sample_plain(points, npoint)
    err = (out.long() - ref.long()).abs().max().item()
    b, n, _ = points.shape
    check(err == 0, f"fps {n}->{npoint}: kernel indices identical to plain")
    # per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare
    nbytes, flops = b * n * 3 * 4 + b * npoint * 4, 10.0 * b * n * (npoint - 1)
    bnd, by = bound_ms(nbytes, flops)
    return {
        "shape": f"B={b} N={n} npoint={npoint}", "max_abs_err": float(err),
        "ms": time_ms(lambda: tfps.furthest_point_sample(points, npoint), reps=10),
        "plain_ms": time_ms(lambda: tfps.furthest_point_sample_plain(points, npoint), 2, 1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def knn_case(query: torch.Tensor, ref: torch.Tensor, k: int) -> dict:
    d, i = knn(query, ref, k)
    pd, pi = knn_plain(query, ref, k)
    err = (d - pd).abs().max().item()
    check(err <= 1e-5, f"knn {query.shape[1]}x{ref.shape[1]} k={k}: distances within 1e-5 "
          f"(max {err:.3g})")
    full = pairwise_sqdist(query, ref)
    differ = i != pi
    # where the sets differ, the kernel's neighbour must tie the plain one's
    kernel_d = torch.gather(full, 2, i.long())
    tie_gap = (kernel_d - pd).abs()[differ]
    worst = tie_gap.max().item() if tie_gap.numel() else 0.0
    check(worst <= 1e-5, f"knn {query.shape[1]}x{ref.shape[1]} k={k}: neighbour sets equal "
          f"except ties within 1e-5 ({int(differ.sum())} positions differ)")
    b, s, _ = query.shape
    n = ref.shape[1]
    # per pair: 3 mul + 2 add (cross), 1 add, 1 mul, 1 sub, 1 max, 1 compare
    nbytes, flops = (b * s * 3 + b * n * 3) * 4 + b * s * k * 8, 10.0 * b * s * n
    bnd, by = bound_ms(nbytes, flops)
    return {
        "shape": f"B={b} S={s} N={n} k={k}", "max_abs_err": err,
        "ms": time_ms(lambda: knn(query, ref, k), reps=20),
        "plain_ms": time_ms(lambda: knn_plain(query, ref, k), 3, 1),
        "bound_ms": bnd, "bound_by": by,
        # torch.topk on the precomputed distance matrix (the matrix not timed)
        "library_ms": time_ms(lambda: torch.topk(full, k, dim=-1, largest=False), 20),
    }


def gather_case(src: torch.Tensor, idx: torch.Tensor) -> dict:
    out = tgather.gather_points(src, idx)
    ref = tgather.gather_points_plain(src, idx)
    err = (out - ref).abs().max().item()
    check(torch.equal(out, ref), f"gather M={idx.shape[1]} C={src.shape[2]}: bit-exact")
    b, _, c = src.shape
    m = idx.shape[1]
    rows = sum(int(torch.unique(idx[j]).numel()) for j in range(b))
    nbytes = b * m * 4 + rows * c * 4 + b * m * c * 4  # idx, the rows read, out
    bnd, by = bound_ms(nbytes, 0.0)
    index = idx.long()[..., None].expand(-1, -1, c)
    return {
        "shape": f"B={b} N={src.shape[1]} M={m} C={c}", "max_abs_err": err,
        "ms": time_ms(lambda: tgather.gather_points(src, idx), reps=50),
        "plain_ms": time_ms(lambda: tgather.gather_points_plain(src, idx), reps=50),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(lambda: torch.gather(src, 1, index), reps=50),
    }


def kernel_phase(scan: torch.Tensor, scan2: torch.Tensor) -> dict:
    """``scan``/``scan2``: two prepared full-width frames ``(1, 8192, 3)``."""
    cases = {"fps": [], "knn": [], "gather": []}
    cases["fps"].append(fps_case(scan, 2048))
    l1 = tgather.gather_points(scan, tfps.furthest_point_sample(scan, 2048))  # (1, 2048, 3)
    l1b = tgather.gather_points(scan2, tfps.furthest_point_sample(scan2, 2048))
    l2 = tgather.gather_points(l1, tfps.furthest_point_sample(l1, 1024))
    cases["fps"].append(fps_case(l1, 1024))
    cases["fps"].append(fps_case(l2, 256))
    cases["knn"].append(knn_case(l1, scan, 32))  # level-1 SetConv grouping
    cases["knn"].append(knn_case(l1, l1b, 6))  # level-1 re-embedding cost volume
    cases["knn"].append(knn_case(l2, l1, 32))  # level-2 SetConv grouping
    _, nn_idx = knn(l1, scan, 32)
    flat = nn_idx.reshape(1, -1).contiguous()  # M = 2048 * 32 = 65,536 rows
    cases["gather"].append(gather_case(scan, flat))
    gen = torch.Generator(device=scan.device).manual_seed(0)
    wide = torch.randn(1, 8192, 67, device=scan.device, generator=gen)
    cases["gather"].append(gather_case(wide, flat))
    return cases


# ---------------------------------------------------------------------------
# Phase 3: the small config, card against CPU
# ---------------------------------------------------------------------------


def small_config_phase(scans: np.ndarray) -> float:
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
    return err


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
    for name, per_fwd in LAUNCHES_PER_FORWARD.items():
        check(counts[name] > 0, f"main path launched the {name} kernel ({counts[name]} times)")
        check(counts[name] == per_fwd * forwards,
              f"{name}: {per_fwd} launches per forward x {forwards} forwards")
    check(per_frame.shape == batched.shape == (n_frames, 4, 4), "pose shapes (T, 4, 4)")
    check(is_se3(per_frame) and is_se3(batched), "poses are finite SE(3)")
    # reported, not held to a bound: the two batchings round the matmuls
    # differently, and the kNN on warped points (|q|^2 + |r|^2 - 2 q.r at
    # ranges of tens of metres) turns such last-bit differences into
    # neighbour swaps near ties, which random weights then amplify
    gap = float(np.abs(per_frame - batched).max())
    log(f"per-frame vs batched pose chains: max gap {gap:.3g}")
    return {"launches": counts, "forwards": forwards, "per_frame_vs_batched_max_gap": gap}


# ---------------------------------------------------------------------------
# Phase 5: end-to-end times
# ---------------------------------------------------------------------------


def timing_phase(odo: PWCLONetOdometry, scans: np.ndarray) -> dict:
    prepared = np.stack([odo._prepare(s) for s in scans])
    x1 = torch.from_numpy(prepared[1:2]).cuda()
    x2 = torch.from_numpy(prepared[0:1]).cuda()
    with torch.inference_mode():
        fwd_ms = [time_ms(lambda: odo.model(x1, x2), reps=10) for _ in range(3)]
        xb1 = torch.from_numpy(prepared[1:]).cuda()
        xb2 = torch.from_numpy(prepared[:-1]).cuda()
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
    pairs = scans.shape[0] - 1
    return {
        "forward_ms_b1": statistics.median(fwd_ms),
        "forward_ms_b1_runs": fwd_ms,
        f"forward_ms_b{pairs}": fwd_batch_ms,
        "process_next_frame_ms_median": 1e3 * statistics.median(frame_s),
        "process_sequence_s_runs": seq_s,
        "process_sequence_pairs_per_s": pairs / statistics.median(seq_s),
        "pairs": pairs,
    }


def profile_forward(odo: PWCLONetOdometry, scans: np.ndarray) -> None:
    from torch.profiler import ProfilerActivity, profile

    prepared = np.stack([odo._prepare(s) for s in scans[:2]])
    x1 = torch.from_numpy(prepared[1:2]).cuda()
    x2 = torch.from_numpy(prepared[0:1]).cuda()
    with torch.inference_mode():
        odo.model(x1, x2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            odo.model(x1, x2)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), file=sys.stderr)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true", help="profile one full-width forward")
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
    odo = PWCLONetOdometry(None, DeepOdometryConfig(), device="cuda", seed=0)
    scan0 = torch.from_numpy(odo._prepare(scans[0])[None]).cuda()
    scan1 = torch.from_numpy(odo._prepare(scans[1])[None]).cuda()

    log("phase 2: kernels against their plain versions")
    cases = kernel_phase(scan0, scan1)

    log("phase 3: small config, card against CPU")
    small_err = small_config_phase(scans)

    log("phase 4: the main path at full width")
    main = main_path_phase(odo, scans)

    log("phase 5: times")
    times = timing_phase(odo, scans)
    if args.profile:
        profile_forward(odo, scans)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        head = cases[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "cases": cases[name],
        })
    metrics = {
        "config": "PWCLONetConfig() full width: 8192 points, reference channel plan, "
                  "fused_eval=False, float32, seeded random weights",
        "build_s": build_s, "sequence_gen_s": gen_s, "small_config_max_abs_err": small_err,
        **main, **times, "total_s": time.perf_counter() - t_start,
    }
    print(card_line())
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernels}))
    for value in (small_err, times["forward_ms_b1"], times["process_sequence_pairs_per_s"]):
        check(math.isfinite(value), "finite result")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
