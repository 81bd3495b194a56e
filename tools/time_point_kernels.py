#!/usr/bin/env python3
"""Time the point-op kernels of a tree's ``pwclonet_pylidarslam_torch`` at
every shape the full-width PWCLO-Net gives them, on one CUDA card.

    python3 tools/time_point_kernels.py [--root DIR] [--reps N] [--per-frame]
                                        [--ops fps,knn,gather,scatter_add,
                                               attentive_aggregate,mlp_maxpool]
                                        [--batch random|world]

``--root`` is the directory that holds the package (default: this
repository). To compare two versions of a kernel, unpack the other tree
somewhere (``git archive <commit> pwclonet_pylidarslam_torch | tar -x -C
build/parent``) and run this script on both roots in turns on one card:
each run is a process of its own, so each builds and loads its own kernels.

FPS and kNN are timed at the shapes of one forward, listed below. The gather
and the scatter-add (the gather's backward) are timed at the shapes they
really get: the script wraps the package's two CUDA wrappers
(``ops/gather.py::_gather_points_cuda`` and ``_scatter_add_rows_cuda``)
during one full-width fused forward at B=1 and one full-width train-mode
forward and backward at batch 8 (the random-cloud batches of
``train_net_torch.py``), records each call's shape, launches and index, and
then times the kernel on that index (random source rows and updates) beside
``torch.gather`` with a ready int64 index, or ``index_add_`` into fresh zeros
with ready int64 rows, and the byte bound (each input read once, each output
written once, over 3.35 TB/s), and checks the kernel against its plain
version to the bit (``bit_equal``; the scatter-add's on the CPU copy of its
inputs, a sequential loop over m). The scatter-add is also timed at one shape
of skewed rows (``scatter_add_skewed``), and at the pose-graph back end's
real shape (``scatter_add_backend``: B=1, N=8192 nodes, M = 2e + p = 236,
the active edges of an 80-frame run's graph with 79 odometry and 39 loop
edges, as slam-icp-loop's, C = 6 and 36). Each kernel is timed twice: on
inputs that repeated calls leave in the 50 MB L2 (``ms``), and alone after a
128 MB buffer is rewritten (``cold_ms``). A profile of that train-mode
forward and backward gives what the two kernels really take there
(``train_step_profile``). In a tree whose scatter-add is a plan and a sum
(``ops/gather.py::ScatterPlan``), ``ms`` is the two, as
``scatter_add_rows`` runs them, ``plan_ms`` the plan alone and ``sum_ms`` a
sum over a plan built once (the back end's case: each accumulation). The
scatter-add's long-row threshold and channel group (``kLongRow``,
``kGroup`` of ``csrc/scatter_add.cu``) are compared as copies of the
package built with other values, under ``--root``. ``--batch world``
records the train step on a batch of KITTI-profile world frames
(``train_net_torch.py dataset=synthetic_world``, 8192 points, batch 8, its
model at seeded weights) instead of the random clouds.

The two fused kernels of the eval path (``--ops
attentive_aggregate,mlp_maxpool``; not in the default set) are timed at the
calls one full-width fused forward at B=1 makes: the script wraps
``ops/costvolume.py::_attentive_aggregate_cuda`` and
``ops/mlp.py::_mlp_maxpool_cuda`` during the forward and keeps, for each
distinct shape (the widths of every stack included), its launches and the
first call's real inputs and folded weights. Each shape gets the kernel's
largest difference from its plain version on the card in full fp32
(``max_abs_err``, held to atol 5e-5 / rtol 1e-4 for the aggregate and 3e-5 /
1e-4 for the MLP; the script exits 1 if one is out), warm ``ms``,
``plain_ms``, and three bounds: fp32 operations on the CUDA cores
(2 x multiply-adds over 67 TFLOP/s), 3xTF32 on the tensor cores (6 x
multiply-adds over 495 TFLOP/s) and bytes (inputs, weights and output once,
over 3.35 TB/s); then the sums weighted by launches, and the two kernels'
device ms in a profiled fused forward (``fused_forward_profile``).

``--per-frame`` times the siamese pyramid's FPS and kNN launches as two of
one frame each (how the network launched them before it stacked both frames
on the batch axis) and not as one of two frames.

Prints the card's name and power limit and one JSON object: device
milliseconds per launch (the launches queued behind a sleeping kernel, so
that the host's pace is not in them) by kernel and shape, and their sums
weighted by the launches of one forward or one train step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM, fp32 on the CUDA cores, published
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores, published
FUSED_TOL = {"attentive_aggregate": dict(atol=5e-5, rtol=1e-4),
             "mlp_maxpool": dict(atol=3e-5, rtol=1e-4)}
TRAIN_BATCH = 8
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


def device_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Device time per call of ``fn()``: ``reps`` calls queued behind a
    sleeping kernel, between two CUDA events. With ``flush``, a buffer
    larger than the L2, it is rewritten before each call and each call is
    timed alone: the call then finds its inputs in device memory, not in L2,
    as the train step's backward finds them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps if flush is not None else 1)]
    torch.cuda._sleep(60_000_000)  # tens of ms: the host queues every call meanwhile
    if flush is None:
        marks[0][0].record()
        for _ in range(reps):
            fn()
        marks[0][1].record()
    else:
        for i, (start, end) in enumerate(marks):
            flush.fill_(float(i))
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks) / reps


def is_scatter_kernel(name: str) -> bool:
    """A device kernel of the port's scatter-add (every version of it names
    its kernels ``scatter_*_kernel``)."""
    return "scatter_" in name and "_kernel" in name and "gather" not in name


def step_profile(run) -> dict:
    """Device time of the gather and scatter-add kernels in ``run()`` (one
    train-mode forward and backward), from the profiler: their time, their
    kernel launches, and every memset's (an earlier scatter-add began with
    one; its plan now runs three kernels and no memset), beside the device
    time of everything."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the first profile of a process can lose its earliest device events
    # while the tracer starts up: profile twice, keep the second
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"device_ms": sum(e.time_range.end - e.time_range.start for e in device) / 1e3}
    for key, keep in (("gather", lambda k: "gather_kernel" in k), ("scatter_add", is_scatter_kernel),
                      ("memset", lambda k: "Memset" in k)):
        picked = [e for e in device if keep(e.name)]
        out[f"{key}_ms"] = sum(e.time_range.end - e.time_range.start for e in picked) / 1e3
        out[f"{key}_device_launches"] = len(picked)
    return out


def recorded_calls(targets: dict, run) -> dict:
    """``run()`` with CUDA wrappers replaced by recording ones. ``targets``
    maps a kind to ``(module, attribute name, key)``, where ``key(*args)``
    names the shape of a call. Returns ``{kind: {shape: [launches, the first
    call's positional arguments, its keyword arguments]}}`` in order of
    first call; the tensors among the positional arguments are cloned."""
    calls = {kind: {} for kind in targets}
    saved = {kind: getattr(mod, attr) for kind, (mod, attr, _) in targets.items()}

    def recording(kind, key):
        def call(*args, **kwargs):
            entry = calls[kind].setdefault(key(*args), [0, None, kwargs])
            entry[0] += 1
            if entry[1] is None:
                entry[1] = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                                 for a in args)
            return saved[kind](*args, **kwargs)
        return call

    for kind, (mod, attr, key) in targets.items():
        setattr(mod, attr, recording(kind, key))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for kind, (mod, attr, _) in targets.items():
            setattr(mod, attr, saved[kind])
    return calls


def gather_targets(gather_mod) -> dict:
    """The gather and scatter-add wrappers of ``ops/gather.py``, keyed by
    ``(B, N, M, C)``."""
    return {"gather": (gather_mod, "_gather_points_cuda",
                       lambda src, idx: (src.shape[0], src.shape[1], idx.shape[1], src.shape[2])),
            "scatter_add": (gather_mod, "_scatter_add_rows_cuda",
                            lambda upd, idx, n: (upd.shape[0], n, upd.shape[1], upd.shape[2]))}


def gather_row(gather_ops, key: tuple, launches: int, idx: torch.Tensor, reps: int,
               flush: torch.Tensor) -> dict:
    b, n, m, c = key
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(b, n, c, device="cuda", generator=gen)
    equal = torch.equal(gather_ops.gather_points(src, idx), gather_ops.gather_points_plain(src, idx))
    index = idx.long()[..., None].expand(-1, -1, c)
    rows = sum(int(torch.unique(idx[j]).numel()) for j in range(b))
    nbytes = 4 * (b * m + rows * c + b * m * c)  # idx, the rows read, out
    return {"shape": f"B={b} N={n} M={m} C={c}", "launches": launches, "bit_equal": equal,
            "ms": device_ms(lambda: gather_ops.gather_points(src, idx), reps),
            "cold_ms": device_ms(lambda: gather_ops.gather_points(src, idx), reps, flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": device_ms(lambda: torch.gather(src, 1, index), reps)}


def scatter_row(gather_ops, key: tuple, launches: int, idx: torch.Tensor, reps: int,
                flush: torch.Tensor) -> dict:
    b, n, m, c = key
    gen = torch.Generator(device="cuda").manual_seed(1)
    upd = torch.randn(b, m, c, device="cuda", generator=gen)
    rows = (idx.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
    upd2d = upd.reshape(b * m, c)
    longest = int(torch.bincount(rows).max()) if rows.numel() else 0
    # the kernel adds in ascending m, as the plain version does on the CPU
    out = gather_ops.scatter_add_rows(upd, idx, n)
    equal = torch.equal(out.cpu(), gather_ops.scatter_add_rows_plain(upd.cpu(), idx.cpu(), n))
    nbytes = 4 * (b * m * c + b * m + b * n * c)  # updates, idx, out
    row = {"shape": f"B={b} N={n} M={m} C={c}", "launches": launches,
           "longest_segment": longest, "bit_equal": equal,
           "ms": device_ms(lambda: gather_ops.scatter_add_rows(upd, idx, n), reps),
           "cold_ms": device_ms(lambda: gather_ops.scatter_add_rows(upd, idx, n), reps, flush),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "library_ms": device_ms(
               lambda: upd.new_zeros((b * n, c)).index_add_(0, rows, upd2d), reps)}
    plan_cls = getattr(gather_ops, "ScatterPlan", None)
    if plan_cls is not None:  # a tree whose scatter-add is a plan and a sum
        plan = plan_cls(idx, n)
        row["bit_equal"] = equal and torch.equal(plan.sum(upd), out)
        row["plan_ms"] = device_ms(lambda: plan_cls(idx, n), reps)
        row["sum_ms"] = device_ms(lambda: plan.sum(upd), reps)
    return row


def weighted_sums(rows: list, keys=("ms", "cold_ms", "bound_ms", "library_ms")) -> dict:
    # the scatter-add's plan and sum apart, where timed
    keys += tuple(k for k in ("plan_ms", "sum_ms") if rows and all(k in r for r in rows))
    return {"launches": sum(r["launches"] for r in rows),
            **{key: sum(r["launches"] * r[key] for r in rows) for key in keys}}


def backend_edges(nodes: int = 80, loops: int = 39, seed: int = 5) -> np.ndarray:
    """``(1, 2e)`` int32: the edge_i then edge_j of a pose graph over
    ``nodes`` frames, an odometry edge between each two in a row and
    ``loops`` loop edges between frames at least 20 apart, as a
    there-and-back run closes them (no priors)."""
    rng = np.random.default_rng(seed)
    i = list(range(nodes - 1))
    j = list(range(1, nodes))
    while len(i) < nodes - 1 + loops:
        a, b = sorted(rng.integers(0, nodes, size=2))
        if b - a >= 20:
            i.append(int(a))
            j.append(int(b))
    return np.asarray([i + j], dtype=np.int32)


def backend_rows(gather_ops, reps: int, flush: torch.Tensor) -> list:
    """The back end's accumulation at its real shape (:func:`backend_edges`
    into the pipeline's 8192 nodes), C = 6 and 36: ``ms`` is a plan and a
    sum; ``sum_ms`` (each accumulation of an optimization) a sum over the
    plan its optimization builds once, ``plan_ms`` that plan; in a tree
    without a plan, ``scatter_add_rows`` is what each accumulation runs."""
    idx = torch.from_numpy(backend_edges()).cuda()
    return [scatter_row(gather_ops, (1, 8192, idx.shape[1], c), 0, idx, reps, flush)
            for c in (6, 36)]


def fused_targets(cv_mod, mlp_mod) -> dict:
    """The fused kernels' wrappers of ``ops/costvolume.py`` and
    ``ops/mlp.py``; a shape names every width of the call, its stacks'
    included."""
    def widths(wb):
        return ",".join(str(w.shape[1]) for w in wb[0])

    def aggregate(cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, center):
        b, s, k, _ = gxyz.shape
        return (f"{'self' if center else 'cross'} B={b} S={s} K={k} Cc={cfeat.shape[-1]} "
                f"Cg={gfeat.shape[-1]} enc({widths(enc_wb)}) "
                f"emb({'' if emb_wb is None else widths(emb_wb)}) att({widths(att_wb)})")

    def mlp(x, *stack):  # (x, wb), or (x, weights, biases) in older trees
        b, s, k, cin = x.shape
        return f"B={b} S={s} K={k} Cin={cin} ({widths(stack[0] if len(stack) == 1 else stack)})"

    return {"attentive_aggregate": (cv_mod, "_attentive_aggregate_cuda", aggregate),
            "mlp_maxpool": (mlp_mod, "_mlp_maxpool_cuda", mlp)}


def fused_row(kind: str, kernel, plain, key: str, launches: int, args: tuple, reps: int) -> dict:
    """One recorded shape of a fused kernel: error against the plain version,
    warm device times and the three bounds."""
    out, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if kind == "attentive_aggregate":
        cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, _ = args
        stacks = [wb for wb in (enc_wb, emb_wb, att_wb) if wb is not None]
        rows, inputs = gxyz.shape[0] * gxyz.shape[1] * gxyz.shape[2], (cxyz, gxyz, cfeat, gfeat)
    else:
        x, *stack = args
        stacks = [stack[0] if len(stack) == 1 else stack]
        rows, inputs = x.shape[0] * x.shape[1] * x.shape[2], (x,)
    macs = rows * sum(w.shape[0] * w.shape[1] for wb in stacks for w in wb[0])
    nbytes = 4 * (sum(t.numel() for t in inputs) + out.numel()
                  + sum(t.numel() for wb in stacks for part in wb for t in part))
    return {"shape": key, "launches": launches, "max_abs_err": (out - ref).abs().max().item(),
            "within_tolerance": torch.allclose(out, ref, **FUSED_TOL[kind]),
            "ms": device_ms(lambda: kernel(*args), reps),
            "plain_ms": device_ms(lambda: plain(*args), reps),
            "bound_fp32_ms": 2.0 * macs / FP32_FLOPS * 1e3,
            "bound_tf32x3_ms": 6.0 * macs / TF32_FLOPS * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def fused_profile(run) -> dict:
    """Device ms of the two fused kernels in ``run()`` (one fused forward),
    from the profiler, beside the device time of everything."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # keep the second: the first can lose early device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"device_ms": sum(e.time_range.end - e.time_range.start for e in device) / 1e3,
           "device_launches": len(device)}
    for key in ("attentive_aggregate", "mlp_maxpool"):
        picked = [e for e in device if key in e.name]
        out[f"{key}_ms"] = sum(e.time_range.end - e.time_range.start for e in picked) / 1e3
        out[f"{key}_device_launches"] = len(picked)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--per-frame", action="store_true",
                        help="the pyramid's launches as two of one frame, not one of two")
    parser.add_argument("--ops", default="fps,knn,gather,scatter_add",
                        help="comma-separated subset of fps, knn, gather, scatter_add, "
                             "attentive_aggregate, mlp_maxpool")
    parser.add_argument("--batch", choices=("random", "world"), default="random",
                        help="the recorded train step's batch: random clouds or world frames")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    wanted = set(args.ops.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pwclonet_pylidarslam_torch import ops
    from pwclonet_pylidarslam_torch.core import se3
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence,
    )
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.ops import costvolume as cv_mod
    from pwclonet_pylidarslam_torch.ops import gather as gather_mod
    from pwclonet_pylidarslam_torch.ops import mlp as mlp_mod
    from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
    from pwclonet_pylidarslam_torch.train import state as tstate

    scans, _ = generate_sequence(SyntheticSequenceConfig(n_frames=2, seed=0))
    odo = PWCLONetOdometry(None, DeepOdometryConfig(model=PWCLONetConfig(fused_eval=True)), seed=0)
    both = odo._prepare(scans)  # (2, 8192, 3), on the card
    out = {"root": args.root}

    if wanted & {"gather", "scatter_add"}:
        def forward():
            with torch.inference_mode():
                odo.model(both[1:2], both[0:1])

        if args.batch == "world":
            # the first batch of train_net_torch.py dataset=synthetic_world and
            # its trainer's seeded state
            import train_net_torch

            with tempfile.TemporaryDirectory() as log_dir:
                wcfg = train_net_torch.parse_cli(train_net_torch.Config, [
                    "dataset=synthetic_world", "num_points=8192", "synthetic_frames=48",
                    f"batch_size={TRAIN_BATCH}", "train_sequences=0", "eval_sequences=0",
                    f"log_dir={log_dir}"])
                batch = next(iter(train_net_torch.make_batch_fns(wcfg)[0]()))
                trainer = train_net_torch._trainer(wcfg)
            cfg, state = trainer.config.train, trainer.state
        else:
            # the random-cloud batch of train_net_torch.py (seed 0), first of its epoch
            r = np.random.default_rng(0)
            pts1 = r.normal(size=(TRAIN_BATCH, 8192, 3)).astype(np.float32) * 8
            pose = se3.exp(torch.from_numpy(
                (r.normal(size=(TRAIN_BATCH, 6)) * 0.05).astype(np.float32)))
            batch = {"xyz1": pts1, "xyz2": se3.transform(pose, torch.from_numpy(pts1)).numpy(),
                     "gt_params": se3.pose_to_params_quat(pose).numpy().astype(np.float32)}
            cfg = tstate.TrainConfig(model=PWCLONetConfig(), total_steps=1000)
            state = tstate.create_train_state(cfg, seed=0)
        out["batch"] = args.batch
        fwd = recorded_calls(gather_targets(gather_mod), forward)
        step = recorded_calls(gather_targets(gather_mod),
                              lambda: tstate.loss_and_grads(cfg, state, batch))
        out["train_step_profile"] = step_profile(lambda: tstate.loss_and_grads(cfg, state, batch))
        del state
        torch.cuda.empty_cache()
        flush = torch.empty(32 << 20, device="cuda")  # 128 MB, over twice the L2
        for name, kind, calls, row_fn in (
                ("gather_forward", "gather", fwd, gather_row),
                ("gather_train_step", "gather", step, gather_row),
                ("scatter_add_train_step", "scatter_add", step, scatter_row)):
            if kind not in wanted:
                continue
            out[name] = [row_fn(gather_mod, key, launches, call[1], args.reps, flush)
                         for key, (launches, call, _) in calls[kind].items()]
            out[f"{name}_sums"] = weighted_sums(out[name])
        if "scatter_add" in wanted:
            # not a path shape: the level-2 grouping's size with one row of
            # each sample taking 4,096 of its updates, the cost of skew
            skew = np.random.default_rng(2)
            idx = skew.integers(0, 2048, size=(2 * TRAIN_BATCH, 32768))
            idx[:, skew.choice(32768, 4096, replace=False)] = 7
            out["scatter_add_skewed"] = scatter_row(
                gather_mod, (2 * TRAIN_BATCH, 2048, 32768, 19), 0,
                torch.from_numpy(idx.astype(np.int32)).cuda(), args.reps, flush)
            out["scatter_add_backend"] = backend_rows(gather_mod, args.reps, flush)

    fused = [kind for kind in ("attentive_aggregate", "mlp_maxpool") if kind in wanted]
    if fused:
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32

        def fused_forward():
            with torch.inference_mode():
                odo.model(both[1:2], both[0:1])

        fused_forward()  # folds (and lays out) the weights once, as a running odometry has
        calls = recorded_calls(fused_targets(cv_mod, mlp_mod), fused_forward)
        out["fused_forward_profile"] = fused_profile(fused_forward)
        kernels = {"attentive_aggregate": (cv_mod._attentive_aggregate_cuda,
                                           cv_mod.attentive_aggregate_plain),
                   "mlp_maxpool": (mlp_mod._mlp_maxpool_cuda, mlp_mod.mlp_maxpool_plain)}
        with torch.inference_mode():
            for kind in fused:
                out[kind] = [fused_row(kind, *kernels[kind], key, launches, call, args.reps)
                             for key, (launches, call, _) in calls[kind].items()]
                out[f"{kind}_sums"] = weighted_sums(out[kind], (
                    "ms", "plain_ms", "bound_fp32_ms", "bound_tf32x3_ms", "bound_bytes_ms"))

    levels = [both]
    for npoint in (2048, 1024, 256, 64):
        idx = ops.furthest_point_sample(levels[-1], npoint)
        levels.append(ops.gather_points(levels[-1], idx))

    def cloud(name: str, paired: bool) -> torch.Tensor:
        lv = levels[int(name[0])]
        if paired:
            return lv
        return lv[1:2] if name.endswith("b") else lv[0:1]

    def split(launches: int, paired: bool) -> tuple:
        return (2 * launches, False) if paired and args.per_frame else (launches, paired)

    if "knn" in wanted:
        out["knn"] = []
        for s, n, k, launches, paired in KNN_SHAPES:
            launches, paired = split(launches, paired)
            q, r = cloud(s, paired), cloud(n, paired)
            ms = device_ms(lambda: ops.knn(q, r, k), args.reps)
            out["knn"].append({"shape": f"B={q.shape[0]} S={q.shape[1]} N={r.shape[1]} k={k}",
                               "launches": launches, "ms": ms})
    if "fps" in wanted:
        out["fps"] = []
        for n, npoint, launches, paired in FPS_SHAPES:
            launches, paired = split(launches, paired)
            p = cloud(n, paired)
            ms = device_ms(lambda: ops.furthest_point_sample(p, npoint), max(3, args.reps // 4))
            out["fps"].append({"shape": f"B={p.shape[0]} N={p.shape[1]} npoint={npoint}",
                               "launches": launches, "ms": ms})
    for name in ("knn", "fps"):
        if name in out:
            out[f"{name}_ms_per_forward"] = sum(c["launches"] * c["ms"] for c in out[name])
            out[f"{name}_launches_per_forward"] = sum(c["launches"] for c in out[name])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    rows = [r for key, v in out.items() if key.startswith(("gather_", "scatter_add_"))
            and not key.endswith(("_sums", "_profile")) for r in (v if isinstance(v, list) else [v])]
    unequal = [r["shape"] for r in rows if not r["bit_equal"]]
    if unequal:
        print(f"not equal to the plain version to the bit: {unequal}", file=sys.stderr)
    outside = [r["shape"] for kind in fused for r in out[kind] if not r["within_tolerance"]]
    if outside:
        print(f"outside the tolerance of the plain version: {outside}", file=sys.stderr)
    return 1 if unequal or outside else 0


if __name__ == "__main__":
    sys.exit(main())
