#!/usr/bin/env python3
"""Run the PyTorch port (PWCLO-Net odometry and training, classic ICP, SLAM,
CT-ICP, PoseResNet, the PointNet++ cls/semseg family, the KITTI-profile
synthetic world, batched ICP, the parallel layer) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--profile] [--kernels] [--icp] [--slam] [--ct_icp] [--posenet]
                          [--cls_seg] [--world] [--batched] [--parallel]

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
   the CPU from the same state: loss within rtol 1e-5 of the CPU's float32
   step, every gradient leaf within atol 1e-4 + 1e-3 of the leaf's largest
   magnitude of the CPU's float64 step on the card's FPS and kNN choices;
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

7. classic ICP odometry (plain PyTorch: no kernel of its own, and none of
   the six above launched) at the full width of ``config/kitti_projective.yaml``
   and ``config/kitti_voxel_accuracy.yaml`` (8192 points): for each mode, the
   card's state after 8 frames carried to the CPU by a snapshot and one step
   on each (poses within 1e-4 m and 1e-4 rad; the share of differing
   model-map pixels or voxel-table slots printed); the 12-frame curve
   sequence of ``tests/test_icp_odometry.py`` against ground truth on the
   card (projective: ATE < 0.02 m/frame and drift < 0.15 m, that test's
   bounds; voxel: 1.5x the JAX reference's worst on the same scans); one
   step with the TF32 switches on globally gives the same pose (1e-6) and
   leaves them as they were; and, over a 32-frame along-path curve, the
   ms/frame of ``process_next_frame`` and ``process_sequence``, device ms,
   launches and idle share a frame from the profiler, host reads and
   Gauss-Newton iterations a frame, synchronizing calls of one step, and
   peak memory.

8. SLAM, loop closure and the pose-graph back end. Phase 2 also holds the
   masked kNN ``torch.equal`` to its plain version (the loop-closure refine's
   shape: a full-width submap's 16,384 points, warped, against the submap
   with the mask its grid sampling left, k=1; k=8 with fewer valid refs than
   k and with none; masked queries; k above N), the refine's gather, and the
   back end's scatter-add at its default capacity (V=8192, M=33,024, C=6 and
   36) against ``index_add_``. Then: the reference's drift scenario
   (``slam/drift_injection.py``; 80 frames there and back at 2048 points,
   the back end off and on) held to the four gates of
   ``tests/test_pipeline.py::test_loop_backend_reduces_drift``, the absolute
   one to the reference's own spread (``DRIFT_REFERENCE_SPREAD``) and, besides,
   the error anchored at frame 1 to 0.5 m; slam-icp-loop
   (``config/kitti_loop_backend.yaml``: ICP at 8192 points, the default loop
   closure widths, back end and ``PGOConfig``) and slam-pwclonet-loop
   (``config/kitti_pwclonet_backend.yaml``: the fused front end from phase
   5's checkpoint) through ``SLAMRunner`` over an 80-frame there-and-back
   sequence at 8192 points, the loop gates reduced to the drift scenario's
   (submaps of 6 frames, overlap 2, 20 frames apart, within 30 m), each with
   the counters zeroed before and read after: exactly 8 masked kNN and 8
   gathers a refinement, 2 scatter-adds a Gauss-Newton iteration and 1 a CG
   iteration launched, and the front end's per-frame counts; finite SE(3)
   poses; result files written; ms a frame, a submap and an optimization,
   iterations, host reads, device ms, launches and idle share over a
   profiled window of frames, peak memory, constraints; then
   ``run_slam_torch.py config=kitti_pwclonet_backend`` on the same
   sequence (exact launch counts, files); and the card against the CPU from
   one state: ``_refine_icp`` on a submap pair that closed a loop and
   ``optimize`` on a 200-node circle with loop edges (poses within 1e-4, the
   cost falling by the same factor within 1e-3), and ``optimize`` twice on
   the card on slam-icp-loop's graph at the default capacity, bit for bit.

9. CT-ICP (plain PyTorch, none of the six kernels launched) at the full
   width of ``config/kitti_ct_icp.yaml`` (8192 points), elastic and rigid,
   over a 32-frame motion-distorted curve (``tests/test_ct_icp.py``'s
   motion, the along-path world): one elastic step from the card's state
   after 8 frames on the card and on the CPU (begin and end pose within
   1e-4, or 3x the card's own movement under a one-ulp nudge of its state's
   poses and scan where that is larger); a step under global TF32 gives the
   same pose (1e-6); the final drift of elastic, rigid and projective ICP,
   elastic within 1.5x the JAX reference's worst on these scans and below
   projective ICP's; ms a frame of ``process_next_frame`` and
   ``process_sequence``, device ms, launches and idle share a frame, GN
   iterations and host reads a frame, peak memory; then
   ``run_slam_torch.py odometry=ct_icp`` with loop closure and the back end
   over 40 synthetic frames.

10. PoseResNet (ResNet-18 on cuDNN convolutions in full fp32, deterministic;
   none of the six kernels launched) at 64x720 vertex maps, batch 8: the
   16x64 config card against CPU (eval and train forward within atol 1e-4 /
   rtol 1e-3, the loss within 1e-5 relative, every gradient leaf within
   1e-4 + 1e-3 of its largest magnitude); six supervised steps through
   ``PoseNetTrainer.train_epoch`` and two unsupervised ones, all finite; the
   same step twice from one state gives bit-identical gradients; the train
   step's ms in fp32 and in TF32, its device launches and idle share, peak
   memory; ``PoseNetOdometry`` from the checkpoint over 10 frames, per frame
   within 1e-4 of ``process_sequence``, and the forward at B=1; then
   ``train_net_torch.py --model posenet`` (train, then test) and
   ``run_slam_torch.py odometry=posenet`` on synthetic data.

11. The PointNet++ cls/semseg family (``models/cls_seg.py``: ball query,
   three-NN interpolation, MSG set abstraction, feature propagation) at the
   upstream recipes' full width, batch 32: cls-ssg and cls-msg on 1,024-point
   procedural shapes, semseg-ssg on 4,096-point, 9-channel procedural rooms.
   FPS, kNN (k=3), the gather and the scatter-add at every call that each
   cell's train-mode forward + backward, eval forward at B=32 and eval
   forward at B=1 make, on those calls' own inputs (recorded by wrapping the
   CUDA wrappers, ``tools/time_point_kernels.py::recorded_calls``): FPS, kNN and the
   gather ``torch.equal`` to their plain versions (the gather up to 512
   columns), the scatter-add ``torch.equal`` to its plain version on the
   CPU copy, the first call of each shape timed, with the scatter-add's
   longest segment (one loop with phase 12, ``recorded_kernel_cases``); the tiny
   plans card against CPU (eval logits within atol 1e-4 / rtol 1e-4; the
   train loss within 1e-5 relative, every gradient leaf within 1e-4 + 1e-3
   of its largest magnitude); per cell the exact launches of one eval
   forward and one train step, six train steps with finite losses, the same
   step twice from one state giving bit-identical gradients, forward ms at
   B=32 and B=1, train-step ms, one profiled forward and step (device ms,
   launches, idle share), peak memory; then ``train_net_torch.py --model
   cls`` and ``--model semseg`` for one epoch on procedural data.

12. The KITTI-profile synthetic world (``data/synthetic.py``: ``kitti_world``
   with its moving traffic, ``kitti_preset``, ``FrameRaycaster``) and
   PWCLO-Net trained and tested on it. Six full 64 x 720 frames of the preset
   cast on the card and on the CPU: they may differ only at borderline rays
   (``tools/cast_check.py``: a rectangle's edge, ``t_min`` / ``t_max``, a
   grazing plane, two rectangles at one range), counted by kind; the moving
   box of ``tests/test_synthetic.py`` followed at +0.5 m a frame; the whole
   995-frame preset generated on the card, its cast and its host loop timed
   apart (and the cast's device time over 50 frames profiled). Then
   ``train_net_torch.main([do_train=true, dataset=synthetic_world,
   num_points=8192, batch_size=8, ...])`` over two train worlds and one eval
   world of 48 frames (the depth cut: worlds, frames, one epoch), the counters
   zeroed before and read after: exactly FPS 5, kNN 19, gather 24 and
   scatter-add 18 launches a step and the unfused forward's a eval batch, the
   fused kernels none; finite losses; the parameters moved. One train step of
   the trained state is recorded (``recorded_calls``): every FPS, kNN and
   gather call ``torch.equal`` to its plain version on its own inputs, every
   scatter-add ``torch.equal`` to its plain version on the CPU copy, the
   first call of each shape timed. Then ``do_test=true fused_eval=true`` on
   a held-out 48-frame world: exactly 15 MLP + max-pool and 8 aggregate
   launches a forward (with FPS 5, kNN 19, gather 24), the reference's result
   files; one fused forward recorded, each of its 15 + 8 fused calls within
   phase 2's tolerance of its plain version or of the same function in
   float64 (at the trained weights' scale the plain float32 version itself
   misses float64 by more than phase 2's atol), and timed; each point-kernel
   call equal to its own.

13. Batched multi-sequence ICP odometry (``BatchedICPOdometry``; plain
   PyTorch, none of the six kernels launched) at the full width of
   ``config/kitti_batched.yaml``: 11 sequences at 8192 points, here 11
   KITTI-profile worlds (``kitti_preset(32, seed=s)``, s = 0..10) of one
   32-frame chunk, projective and voxel. Per mode: one batched step from the
   batched state after 8 frames against ``process_frame`` of each sequence
   from its slice of that state (1e-5 m). Projective, whose chains lose
   track on most of these worlds: at every frame, each sequence's batched
   step against ``process_frame`` from the same state, within 1e-5 m and
   with the same iterations wherever that single step converged before its
   iteration cap and moves by less than 1e-5 m when its scan is moved by
   one ulp (the chains are printed, not held). Voxel: each
   32-frame chain against ``ICPOdometry`` on the card within max(1e-3, 3x
   the single path's own movement under a one-ulp nudge of that sequence's
   scans, up and down). Both: two equal
   sequences within 1e-5 m of each other (bit-equality printed); ms a batched
   step, frames/s summed over the sequences beside the serial
   ``ICPOdometry``'s, launches, device ms and host reads a step at S=1 and
   S=11 and the idle share over 4 profiled steps, peak memory, ATE and
   t_rel (5-20 m segments) a sequence. Then ``run_slam_torch.py
   config=kitti_batched dataset=synthetic`` over 11 sequences of 32 frames
   with ``profile_dir``: the result files, and CUDA kernel events in the
   trace.

14. The parallel layer (``pwclonet_pylidarslam_torch/parallel/``) on a NCCL
   group of this process alone (the card's machine has one H100), last,
   since it sets the group up and destroys it: ``make_mesh(1, 1)``, and
   ``make_mesh(2, 1)`` refused; ``solve_point_to_plane_sharded`` on one
   8192-point alignment from a KITTI-profile frame, the voxel table of
   ``ICPConfig()`` built sharded and queried by 8192 points,
   ``optimize_sharded`` on phase 8's 200-node circle (the scatter-add kernel,
   its launches counted exactly) and ``BatchedICPOdometry(mesh=...)`` over
   phase 13's 11 worlds x 8 frames, projective, each ``torch.equal`` to its
   unsharded counterpart; ``make_parallel_train_step`` at full width (the
   default ``PWCLONetConfig``, 8192 points, batch 8), two steps from one
   seeded state against ``train_step`` at the reference's bar (loss rtol
   1e-4; the parameters' differences under 1e-4 at the 99.9th percentile and
   1e-2 at most), its launches a step exactly a train step's, the ms a step
   of both printed; and ``measure_scaling`` at mesh size 1 (batch 8 a
   device), whose JSON line it prints.

Prints the card's name and power limit, a ``{"metrics": ...}`` line, a
``{"variants": ...}`` line (the FPS kernel's time at each cluster size and
thread count, the kNN kernel's at each number of queries a block, the MLP
kernel's at each tile), a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if CUDA is unavailable or any check
fails. ``--profile`` profiles one full-width forward of each configuration
and prints the tables of those and of the train step on stderr; device time
by kernel, launches and idle share go into the metrics. ``--kernels`` stops
after phase 2 and prints the cases and the variants (no last line); ``--icp``
runs phase 7 alone (no build) and prints its metrics (no last line);
``--slam`` builds, runs phase 2's SLAM cases and phase 8 alone (with a
checkpoint of seeded weights instead of phase 5's) and prints its metrics
(no last line); ``--ct_icp`` and ``--posenet`` run phase 9 and phase 10
alone (no build) and print their metrics (no last line); ``--cls_seg``
builds and runs phase 11 alone and prints its metrics (no last line);
``--world`` builds and runs phase 12 alone and prints its metrics and a
kernels line of the six kernels on its path (no last line); ``--batched``
runs phase 13 alone (no build) and prints its metrics (no last line);
``--parallel`` builds and runs phase 14 alone and prints its metrics (no
last line).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from pwclonet_pylidarslam_torch.data.synthetic import (  # noqa: E402
    DynamicBox,
    FrameRaycaster,
    Rect,
    SyntheticSequenceConfig,
    cast_rigid_sweeps,
    generate_sequence,
    generate_sequence_with_times,
    kitti_preset,
    kitti_world,
    lidar_directions,
    make_trajectory,
)
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector  # noqa: E402
from pwclonet_pylidarslam_torch.data import shapes, vm_pairs  # noqa: E402
from pwclonet_pylidarslam_torch.models import posenet  # noqa: E402
from pwclonet_pylidarslam_torch import ops  # noqa: E402
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig  # noqa: E402
from pwclonet_pylidarslam_torch.models import cls_seg as cls_seg_models  # noqa: E402
from pwclonet_pylidarslam_torch.models import load_flax_variables  # noqa: E402
from pwclonet_pylidarslam_torch.models.layers import PointMLP  # noqa: E402
from pwclonet_pylidarslam_torch.ops import _cuda  # noqa: E402
from pwclonet_pylidarslam_torch.ops import fps as tfps  # noqa: E402
from pwclonet_pylidarslam_torch.ops import gather as tgather  # noqa: E402
from pwclonet_pylidarslam_torch.ops import costvolume as cv_mod  # noqa: E402
from pwclonet_pylidarslam_torch.ops.costvolume import attentive_aggregate_plain  # noqa: E402
from pwclonet_pylidarslam_torch.ops.knn import (  # noqa: E402
    _knn_cuda,
    knn,
    knn_plain,
    masked_sqdist,
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
from pwclonet_pylidarslam_torch.evaluation import metrics as odo_metrics  # noqa: E402
from pwclonet_pylidarslam_torch.slam import icp_odometry as icp  # noqa: E402
from pwclonet_pylidarslam_torch.slam import ct_icp_odometry as ct_icp  # noqa: E402
from pwclonet_pylidarslam_torch.slam import deep_odometry as slam_deep  # noqa: E402
from pwclonet_pylidarslam_torch.core import se3  # noqa: E402
from pwclonet_pylidarslam_torch.core.registration import planar_to_pose, register_bev  # noqa: E402
from pwclonet_pylidarslam_torch.evaluation.results import read_poses_txt  # noqa: E402
from pwclonet_pylidarslam_torch.slam import backend, drift_injection, loop_closure  # noqa: E402
from pwclonet_pylidarslam_torch.slam import pipeline, runner as runner_mod  # noqa: E402
from pwclonet_pylidarslam_torch.train import state as tstate  # noqa: E402
from pwclonet_pylidarslam_torch import parallel as par  # noqa: E402
from pwclonet_pylidarslam_torch.core import optimization as opt  # noqa: E402
from pwclonet_pylidarslam_torch.models import layers  # noqa: E402
from pwclonet_pylidarslam_torch.parallel.mesh import all_gather_rows, mesh_axis  # noqa: E402
from pwclonet_pylidarslam_torch.parallel.scaling import (  # noqa: E402
    ScalingConfig,
    measure_scaling,
    random_batch,
)
from pwclonet_pylidarslam_torch.slam import local_map as lm  # noqa: E402
from pwclonet_pylidarslam_torch.train.fast_lane import run_fast_lane_recipe  # noqa: E402
from pwclonet_pylidarslam_torch.train.losses import pwclonet_loss  # noqa: E402
from pwclonet_pylidarslam_torch.train import posenet_state as pn_state  # noqa: E402
from pwclonet_pylidarslam_torch.train import posenet_trainer  # noqa: E402
from pwclonet_pylidarslam_torch.train import cls_seg as cls_seg_train  # noqa: E402
from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig  # noqa: E402
import run_slam_torch  # noqa: E402
import train_net_torch  # noqa: E402
from tools.cast_check import cast_differences  # noqa: E402
from tools.time_point_kernels import (  # noqa: E402
    fused_targets,
    gather_targets,
    recorded_calls,
    weighted_sums,
)

# the module: the package's ``ops.knn`` is the function it exports
knn_mod = importlib.import_module("pwclonet_pylidarslam_torch.ops.knn")

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
    # the same kernel with masks: loop closure's refine (the reference's
    # masked calls never reach Pallas; its kernel is the TPU kNN's port)
    "knn_masked": ("pwclonet_pylidarslam_torch/csrc/knn.cu",
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


def scatter_case(gen: torch.Generator, idx: torch.Tensor, n: int, c: int, what: str,
                 upd: torch.Tensor = None) -> dict:
    """``idx (B, S, K)``: a grouping's neighbour indices into ``n`` source
    rows; the incoming gradient is ``upd (B, S*K, c)``, random when None. The kernel adds
    each row's updates in ascending m from 0.0f, as ``index_add_`` does on
    the CPU: it must equal that to the bit."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1).contiguous()
    m = flat.shape[1]
    if upd is None:
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


def grad_gap_share(grads: dict, ref_grads: dict) -> float:
    """The largest gap of ``grads`` from ``ref_grads`` over the leaves, in
    units of the bar atol 1e-4 + 1e-3 of the reference leaf's largest
    magnitude."""
    return max((grads[name].cpu() - ref).abs().max().item()
               / (1e-4 + 1e-3 * ref.abs().max().item()) for name, ref in ref_grads.items())


@contextlib.contextmanager
def neighbour_choices(recorded: list, moved: Optional[list] = None):
    """``ops.furthest_point_sample`` and ``ops.knn`` recorded in call order
    into ``recorded`` or, with ``moved`` given, replayed from it: a replayed
    call returns the recorded indices and appends to ``moved`` how many of
    its own differ."""
    saved = {name: getattr(ops, name) for name in ("furthest_point_sample", "knn")}
    order = iter(range(1 << 30))

    def wrap(name):
        def call(*args, **kwargs):
            out = saved[name](*args, **kwargs)
            idx = out[1] if name == "knn" else out
            if moved is None:
                recorded.append(idx)
                return out
            want = recorded[next(order)].to(idx.device)
            if want.shape != idx.shape:
                check(False, f"the replayed {name} call has the recorded call's shape "
                      f"({tuple(want.shape)} against {tuple(idx.shape)})")
            moved.append(int((want != idx).sum()))
            return (out[0], want) if name == "knn" else want
        return call

    for name in saved:
        setattr(ops, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def small_train_phase(scans: np.ndarray) -> dict:
    """One train-mode forward + backward of the small config on the card
    (gather and scatter-add kernels) against the CPU from the same state,
    dropout off: the loss against the CPU's float32 step, the gradients
    against its float64 step on the card's FPS and kNN choices. On the
    corridor's scans the float32 step rounds the cost volumes' point-pair
    encodings enough to move its own gradients by ~1.6 bars from the float64
    step's; the card's and the CPU's float32 gap is reported."""
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
    choices: list = []
    with neighbour_choices(choices):
        loss, _, grads = tstate.loss_and_grads(cfg, gpu, batch)
    torch.cuda.synchronize()
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_err <= 1e-5, f"small config train step: card vs CPU loss within rtol 1e-5 "
          f"({loss.item():.6f} vs {ref_loss.item():.6f})")
    exact = tstate.create_train_state(cfg, seed=1, device="cpu")
    exact.model.load_state_dict(cpu.model.state_dict())
    _dropout_off(exact.model)
    exact.model.double()
    for param in exact.loss_params.values():
        param.data = param.data.double()
    moved: list = []
    with neighbour_choices(choices, moved):
        exact_grads = tstate.loss_and_grads(cfg, exact, {
            k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()})[2]
    check(len(moved) == len(choices), f"the float64 step made the card step's {len(choices)} "
          f"FPS and kNN calls ({len(moved)})")
    worst = grad_gap_share(grads, exact_grads)
    cpu_share = grad_gap_share(ref_grads, exact_grads)
    card_vs_cpu = grad_gap_share(grads, ref_grads)
    check(worst <= 1.0, "small config train step: every gradient leaf within atol 1e-4 + 1e-3 of "
          f"its largest magnitude of the CPU's float64 step (worst at {worst:.3g} of the bar; "
          f"the CPU's float32 step at {cpu_share:.3g}, the card from it at {card_vs_cpu:.3g}; "
          f"{len(ref_grads)} leaves; {sum(moved)} FPS / kNN indices of the float64 step's own "
          f"replaced by the card's)")
    return {"small_train_loss_rel_err": loss_err, "small_train_grad_worst_share_of_bar": worst,
            "small_train_cpu_float32_share_of_bar": cpu_share,
            "small_train_card_vs_cpu_float32_share_of_bar": card_vs_cpu,
            "small_train_float64_indices_replaced": sum(moved)}


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



# ---------------------------------------------------------------------------
# Phase 7: classic ICP odometry at full width (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------

# the two configurations users run: config/kitti_projective.yaml (8192
# points, a 64x720 map, 20 keyframes, 15 alignments, Huber 0.1, the gate
# from 4.0 to 0.5 m) and config/kitti_voxel_accuracy.yaml (voxel
# association: 1.5 m cells in octants, 2^14 x 64 buckets, 0.45 m grid
# sample, candidate cache at margin 0.25, latest keyframe skipped)
ICP_CONFIGS = {
    "projective": icp.ICPConfig(num_points=8192),
    "voxel": icp.ICPConfig(num_points=8192, association="voxel"),
}
ICP_FRAMES = 32  # the timing sequence: along-path world, curving
ICP_CARRY_FRAMES = 8  # card-against-CPU step: the card's state after 8 frames
# card against CPU from one state, one step: the same ops on other hardware
# (libm, reduction order) may flip a pixel or a bucket boundary, which moves
# one match; the reference's own step moves by ~1e-6 when its scan moves by
# one float32 ulp
ICP_STEP_ATOL_M = 1e-4
ICP_STEP_ATOL_RAD = 1e-4
# the whole 12-frame curve sequence of tests/test_icp_odometry.py against
# ground truth. Projective: that test's bounds. Voxel: no test holds it;
# the JAX reference on this generator's earlier scans (each rigid frame cast
# by the numpy raycaster, 8192 points) on the CPU gave ATE 0.00922 m/frame
# and final drift 0.00683 m, and on the scans moved by one float32 ulp up and
# down 0.00612 / 0.00446 and 0.00818 / 0.00706; the bound is 1.5x the worst
# of the three. On the scans of FrameRaycaster (the reference's own since
# then) it gives 0.00884 / 0.00593, 0.00622 / 0.00400 and 0.00847 / 0.00774:
# inside the bound, which stays
ICP_ACCURACY_BOUNDS = {
    "projective": {"ate": 0.02, "drift": 0.15},
    "voxel": {"ate": 1.5 * 0.00922, "drift": 1.5 * 0.00706},
}
TF32_POSE_ATOL = 1e-6  # TF32 products would move the pose by ~1e-3


def icp_rotation_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Angle between two rotations, from the skew part of ``aᵀb`` in
    float64 (``arccos`` of the trace reads ~5e-4 rad for equal float32
    rotations)."""
    rel = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    w = 0.5 * np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0], rel[1, 0] - rel[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


def icp_card_vs_cpu(mode: str, scans: np.ndarray, snap_dir: str) -> dict:
    """Carry the card's state after ``ICP_CARRY_FRAMES`` frames over to the
    CPU through a snapshot, step once on each, compare the poses and the
    share of model-map pixels or voxel-table slots that differ."""
    cfg = ICP_CONFIGS[mode]
    card = icp.ICPOdometry(cfg, device="cuda")
    card.init()
    card.process_sequence(scans[:ICP_CARRY_FRAMES])
    path = str(Path(snap_dir) / f"{mode}.npz")
    card.snapshot(path)
    cpu = icp.ICPOdometry(cfg, device="cpu")
    cpu.restore(path)
    card.restore(path)
    state = {"cuda": card.state, "cpu": cpu.state}
    scan = scans[ICP_CARRY_FRAMES]
    card.process_next_frame(scan)
    cpu.process_next_frame(scan)
    pa, pb = card.results[-1].pose, cpu.results[-1].pose
    trans_gap = float(np.abs(pa[:3, 3] - pb[:3, 3]).max())
    rot_gap = icp_rotation_gap(pa, pb)
    if mode == "projective":
        a, b = card.state.model.cpu(), cpu.state.model
        what = "model-map pixels"
    else:
        predicted = {d: st.pose @ st.last_rel for d, st in state.items()}
        with icp.full_fp32_products():
            ta = icp.frame_voxel_table(cfg, state["cuda"].map, predicted["cpu"].cuda())
            tb = icp.frame_voxel_table(cfg, state["cpu"].map, predicted["cpu"])
        a, b = ta.points.cpu().reshape(-1, 3), tb.points.reshape(-1, 3)
        what = "voxel-table slots"
    differ = float((a != b).any(dim=-1).float().mean())
    # another point won the pixel or the slot (not only its last bits)
    moved = float(((a - b).abs() > 1e-3).any(dim=-1).float().mean())
    log(f"ICP {mode}: card vs CPU one step: {trans_gap:.3g} m, {rot_gap:.3g} rad; "
        f"{100 * differ:.4f} % of {what} differ in some bit, {100 * moved:.4f} % by > 1 mm")
    check(trans_gap <= ICP_STEP_ATOL_M and rot_gap <= ICP_STEP_ATOL_RAD,
          f"ICP {mode}: card and CPU steps from one state within {ICP_STEP_ATOL_M} m and "
          f"{ICP_STEP_ATOL_RAD} rad")
    return {"step_trans_gap_m": trans_gap, "step_rot_gap_rad": rot_gap,
            "differing_share": differ, "differing_share_over_1mm": moved, "differing_of": what,
            "num_matches": [float(card.results[-1].num_matches),
                            float(cpu.results[-1].num_matches)]}


def icp_accuracy(mode: str) -> dict:
    scans, gt = generate_sequence(SyntheticSequenceConfig(
        n_frames=12, trajectory="curve", speed=1.0, seed=2))
    odo = icp.ICPOdometry(ICP_CONFIGS[mode], device="cuda")
    odo.init()
    for scan in scans:
        odo.process_next_frame(scan)
    pred = odo.absolute_poses()
    ate, _ = odo_metrics.compute_ate(odo_metrics.compute_relative_poses(pred),
                                     odo_metrics.compute_relative_poses(gt))
    drift = float(np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3]))
    bound = ICP_ACCURACY_BOUNDS[mode]
    log(f"ICP {mode}: 12-frame curve sequence on the card: ATE {ate:.5f} m/frame, "
        f"final drift {drift:.5f} m")
    check(ate < bound["ate"] and drift < bound["drift"],
          f"ICP {mode}: ATE < {bound['ate']:.5f} m/frame and drift < {bound['drift']:.5f} m")
    return {"ate_m_per_frame": float(ate), "final_drift_m": drift, "bounds": bound}


def icp_tf32_check(scans: np.ndarray) -> dict:
    """One full-width projective step with the TF32 switches off, then the
    same step with them on globally: the step sets its own precision."""
    cfg = ICP_CONFIGS["projective"]
    odo = icp.ICPOdometry(cfg, device="cuda")
    odo.init()
    odo.process_sequence(scans[:4])
    st = odo.state
    pts = torch.from_numpy(scans[4]).cuda()
    poses = {}
    for tf32 in (False, True):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            _, res = icp.process_frame(cfg, st, pts)
            poses[tf32] = res.pose.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "ICP: the TF32 switches are restored after the step")
    gap = float(np.abs(poses[True] - poses[False]).max())
    check(gap <= TF32_POSE_ATOL,
          f"ICP: a step under global TF32 gives the same pose ({gap:.3g} <= {TF32_POSE_ATOL})")
    return {"tf32_on_pose_gap": gap}


def icp_sync_sites(cfg, state, scan: torch.Tensor) -> dict:
    """Synchronizing calls of one step, as ``torch.cuda.set_sync_debug_mode``
    flags them, by the Python line that made them."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            icp.process_frame(cfg, state, scan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites: dict = {}
    for w in seen:
        if "synchroniz" in str(w.message).lower():
            key = f"{Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def icp_timing(mode: str, scans: np.ndarray) -> dict:
    """ms/frame of ``process_next_frame`` (median, after the first frame) and
    of ``process_sequence`` (upload, steps, one fetch), device ms, launches
    and idle share per frame from a profiled stretch of frames, host reads
    and Gauss-Newton iterations per frame, peak memory."""
    cfg = ICP_CONFIGS[mode]
    odo = icp.ICPOdometry(cfg, device="cuda")
    odo.init()
    odo.process_next_frame(scans[0])  # warm
    odo.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    for scan in scans:
        t0 = time.perf_counter()
        odo.process_next_frame(scan)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    iters = list(odo.iterations)
    reads = list(odo.host_reads)
    peak = torch.cuda.max_memory_allocated()
    seq_ms = []
    for _ in range(2):
        odo.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odo.process_sequence(scans)  # ends in a device-to-host copy
        seq_ms.append(1e3 * (time.perf_counter() - t0) / len(scans))
    # a profiled stretch of frames from the state after the warm-up frames
    prof_frames = 4
    odo.init()
    odo.process_sequence(scans[:8])
    st0 = odo.state
    dev_scans = torch.from_numpy(scans[8:8 + prof_frames]).cuda()

    def stretch():
        st = st0
        for t in range(prof_frames):
            st, _ = icp.process_frame(cfg, st, dev_scans[t])

    _, device = profile_device_events(stretch)
    prof = summarize_device_events(device)
    sites = icp_sync_sites(cfg, st0, dev_scans[0])
    syncs = sum(sites.values())
    out = {
        "process_next_frame_ms_median": statistics.median(frame_ms[1:]),
        "process_sequence_ms_per_frame": statistics.median(seq_ms),
        "process_sequence_ms_per_frame_runs": seq_ms,
        "device_ms_per_frame": prof["device_ms"] / prof_frames,
        "launches_per_frame": prof["device_launches"] / prof_frames,
        "idle_share": prof["idle_share"],
        "gn_iterations_per_frame": statistics.mean(iters),
        "host_reads_per_frame": statistics.mean(reads),
        "synchronizing_calls_one_step": syncs, "synchronizing_call_sites": sites,
        "peak_memory_bytes": peak,
        "top_kernels": prof["top_kernels"][:6],
    }
    log(f"ICP {mode}: process_next_frame {out['process_next_frame_ms_median']:.2f} ms/frame, "
        f"process_sequence {out['process_sequence_ms_per_frame']:.2f} ms/frame, device "
        f"{out['device_ms_per_frame']:.3f} ms and {out['launches_per_frame']:.0f} launches a "
        f"frame, idle {out['idle_share']:.3f}, {out['gn_iterations_per_frame']:.2f} GN "
        f"iterations and {out['host_reads_per_frame']:.2f} host reads a frame "
        f"({syncs} synchronizing calls in one step), peak {peak / 2**20:.0f} MiB")
    return out


def icp_phase() -> dict:
    log(f"generating a {ICP_FRAMES}-frame along-path curve sequence at 8192 points")
    t0 = time.perf_counter()
    scans, _ = generate_sequence(SyntheticSequenceConfig(
        n_frames=ICP_FRAMES, trajectory="curve", yaw_rate_deg=2.0, speed=1.0, seed=5,
        world="along_path"))
    gen_s = time.perf_counter() - t0
    out = {"sequence_gen_s": gen_s, "configs": {k: repr(v) for k, v in ICP_CONFIGS.items()}}
    _cuda.reset_launch_counts()
    with tempfile.TemporaryDirectory() as snap_dir:
        for mode in ICP_CONFIGS:
            out[mode] = {**icp_card_vs_cpu(mode, scans, snap_dir), **icp_accuracy(mode)}
    out["tf32"] = icp_tf32_check(scans)
    for mode in ICP_CONFIGS:
        out[mode].update(icp_timing(mode, scans))
    counts = _cuda.launch_counts()
    check(all(v == 0 for v in counts.values()),
          "ICP path launched none of the point-op kernels (plain PyTorch)")
    return out

# ---------------------------------------------------------------------------
# Phase 8: SLAM, loop closure and the pose-graph back end
# ---------------------------------------------------------------------------

# the there-and-back world of the reference's drift scenario
# (slam/drift_injection.py::run_drift_scenario), at the front ends' 8192 points
SLAM_FRAMES = 80
# config/kitti_loop_backend.yaml and config/kitti_pwclonet_backend.yaml keep
# LoopClosureConfig()'s widths (2048 points a frame, 16,384 a submap, 0.5 m
# sampling, a 256-pixel BEV at 0.5 m, 8 refine iterations, confidence 2.0,
# RMSE 0.6), the back end's capacity (8192 / 16384 / 256) and PGOConfig();
# reduced: the temporal gates, to the drift scenario's (KITTI's
# min_id_distance of 200 needs more than 250 frames)
SLAM_LOOP_REDUCED = dict(submap_size=6, overlap=2, min_id_distance=20, max_distance=30.0)
SLAM_CARD_CPU_ATOL = 1e-4  # m / rad: the same ops, other reduction orders
PGO_COST_RTOL = 1e-3
SLAM_PROFILE_FRAMES = 4  # one submap period: a search and, where found, an optimization
# The drift scenario's absolute gate, final_on < 0.5 m, is decided by its
# first ICP step (identity prior, 1.6 m of motion), which no loop constraint
# observes (the first submap's mid frame is frame 3). That step lands short
# on many inputs, in the reference too, and which ones depends on how the
# scan's spherical projection rounds (atan2, asin, the range). Over its
# scans moved by -12..12 float32 ulp the reference's final_on is 0.5 m or
# more on 11 of 25 (at most 0.925 m). With that projection taken in float64
# (the port's first step with it equals the card's on 10 of the 25 inputs),
# its first step lands short on 21 of 25, as the card's does, and final_on
# is 0.5 m or more on 18 of 25, at most 1.0832 m. So the card's final_on is
# held to that spread, and the error anchored at frame 1 (what the back end
# can correct) to 0.5 m. Measured on a CPU by tests/drift_nudges.py.
DRIFT_REFERENCE_SPREAD = 1.0832  # m
DRIFT_ANCHOR = 1


class _Frames:
    """A sequence source for ``SLAMRunner``."""

    def __init__(self, scans: np.ndarray, gt: np.ndarray):
        self.scans, self.gt = scans, gt

    def __len__(self):
        return len(self.scans)

    def scan(self, idx):
        return self.scans[idx]

    def ground_truth(self):
        return self.gt


def slam_sequence(num_points: int = 8192):
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=SLAM_FRAMES, trajectory="there_and_back", speed=1.6, seed=5,
        num_points=num_points))


def slam_config(**kw) -> pipeline.SLAMConfig:
    return pipeline.SLAMConfig(
        odometry=icp.ICPConfig(num_points=8192), with_loop_closure=True,
        loop_closure=loop_closure.LoopClosureConfig(**SLAM_LOOP_REDUCED), with_backend=True, **kw)


def masked_knn_case(query, ref, k, qmask, rmask, what: str) -> dict:
    d, i = knn(query, ref, k, qmask, rmask)
    pd, pi = knn_plain(query, ref, k, qmask, rmask)
    b, s, _ = query.shape
    n = ref.shape[1]
    share = 0.0 if rmask is None else float((rmask <= 0).float().mean())
    name = f"B={b} S={s} N={n} k={k} ({what}; {100 * share:.0f} % of refs masked)"
    err = (d - pd).abs().max().item()
    check(torch.equal(d, pd), f"masked knn {name}: distances equal to plain to the bit")
    check(torch.equal(i, pi), f"masked knn {name}: indices equal to plain "
          f"({int((i != pi).sum())} positions differ)")
    # per pair as unmasked (10 operations); masks read once
    nbytes = (b * s * 3 + b * n * 3) * 4 + b * (s + n) + b * s * k * 8
    bnd, by = bound_ms(nbytes, 10.0 * b * s * n)
    full = masked_sqdist(query, ref, rmask)
    return {
        "shape": name, "max_abs_err": err, "bound_ms": bnd, "bound_by": by,
        "distance_evaluations": b * s * n,
        # library: torch.topk on the ready masked distances (not timed)
        **kernel_times(lambda: knn(query, ref, k, qmask, rmask),
                       lambda: knn_plain(query, ref, k, qmask, rmask),
                       lambda: torch.topk(full, k, dim=-1, largest=False), 20, 2),
    }


def loop_closure_submap(scans: np.ndarray, gt: np.ndarray):
    """The first submap of ``LoopClosureConfig()``'s widths over eight
    corridor frames (2048 grid-sampled points each, 16,384 a submap): the
    refine's reference cloud, masked where the grid sampling left padding."""
    lc = loop_closure.ElevationImageLoopClosure(
        loop_closure.LoopClosureConfig(submap_size=8, overlap=0))
    for t in range(8):
        lc.process_next_frame(scans[t], gt[t])
    return lc.submaps[0]


def masked_knn_cases(sm) -> list:
    """The masked kNN at the loop-closure refine's shape (a full-width
    submap ``sm``'s 16,384 points, warped, against the submap with its mask,
    k=1), then the masks' corner cases: fewer valid refs than k, none,
    masked queries, k above N."""
    ref = torch.from_numpy(sm.points).cuda()[None]
    rmask = torch.from_numpy(sm.mask).cuda()[None]
    warp = se3.exp(torch.tensor([0.3, -0.2, 0.0, 0.0, 0.0, 0.02], device="cuda"))
    query = se3.transform(warp[None], ref)
    cases = [masked_knn_case(query, ref, 1, None, rmask, "loop-closure refine")]
    few = torch.ones(2, 300, device="cuda")
    few[0] = 0.0
    few[0, [3, 77, 150]] = 1.0  # sample 0: three valid refs for k = 8
    few[1] = 0.0  # sample 1: none
    q2, r2 = query[:, :400].reshape(2, 200, 3), ref[:, 1000:1600].reshape(2, 300, 3)
    cases.append(masked_knn_case(q2, r2, 8, None, few, "fewer valid refs than k, and none"))
    qm = (torch.arange(400, device="cuda").reshape(2, 200) % 3 != 0).float()
    cases.append(masked_knn_case(q2, r2, 8, qm, torch.ones_like(few), "masked queries"))
    d, i = knn(q2, r2[:, :5].contiguous(), 8, qm, few[:, :5].contiguous())
    cpu = knn(q2.cpu(), r2[:, :5].cpu(), 8, qm.cpu(), few[:, :5].cpu())
    check(torch.equal(d.cpu(), cpu[0]) and torch.equal(i.cpu(), cpu[1]),
          "masked knn k=8 above N=5 with masks: padded as the CPU pads it")
    return cases


def full_pose_graph(nodes: int = 8192, edges: int = 16384, priors: int = 256):
    """A graph that fills the back end's default capacity (a chain of poses,
    random edges across it, priors): its accumulation index has
    2 x 16,384 + 256 = 33,024 entries into 8,192 rows."""
    rng = np.random.default_rng(0)
    b = backend.PoseGraphBuilder(nodes, edges, priors)
    for t in range(nodes):
        pose = np.eye(4)
        pose[0, 3] = t
        b.add_node(pose)
    for t in range(nodes - 1):
        b.add_odometry_edge(t, np.linalg.inv(b.poses[t]) @ b.poses[t + 1])
    for i, j in rng.integers(0, nodes, size=(edges - nodes + 1, 2)):
        b.add_loop_edge(int(i), int(j), np.linalg.inv(b.poses[i]) @ b.poses[j])
    for i in rng.integers(0, nodes, size=priors):
        b.add_absolute_edge(int(i), b.poses[i])
    return b.to_device()


def backend_scatter_cases() -> list:
    """The back end's scatter-add at the default capacity, full (V = 8192,
    M = 33,024), C = 6 (CG matvec, gradient) and C = 36 (6x6 blocks)."""
    graph = full_pose_graph()
    idx = backend._Accumulator(graph).idx[..., None]  # (1, M, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    return [scatter_case(gen, idx, 8192, c, f"pose-graph back end, {what}")
            for c, what in ((6, "CG matvec and gradient"), (36, "6x6 diagonal blocks"))]


def refine_gather_case(sm) -> dict:
    """The refine's gather of the matched points in submap ``sm``: (1, 16384,
    3) by (1, 16384)."""
    ref = torch.from_numpy(sm.points).cuda()[None]
    rmask = torch.from_numpy(sm.mask).cuda()[None]
    _, idx = knn(ref + 0.1, ref, 1, ref_mask=rmask)
    return gather_case(ref, idx[..., 0].contiguous())


def cg_launches(ran: int, config: backend.PGOConfig) -> int:
    """CG iterations the back end launches in a Gauss-Newton iteration whose
    CG ran ``ran`` (the device's own count of unfrozen iterations): whole
    chunks of ``CG_CHECK_EVERY``, at least one, up to the chunk in which the
    exit held, at most ``config.cg_iterations``."""
    chunk = backend.CG_CHECK_EVERY
    return min(config.cg_iterations, max(1, -(-ran // chunk)) * chunk)


def expected_slam_launches(slam, forwards: int, fused: bool) -> dict:
    """Launches a SLAM run must have made: the front end's per forward, 8
    masked kNN and 8 gathers a refinement, and a scatter-add for each
    back-end accumulation (2 a Gauss-Newton iteration, 1 a CG iteration
    launched, from :func:`cg_launches`)."""
    out = {name: n * forwards for name, n in LAUNCHES_PER_FORWARD[fused].items()}
    refine = slam.loop_closure.stats.refinements * slam.loop_closure.config.icp_iterations
    out["knn"] += refine
    out["gather"] += refine
    for o in slam.optimizations:
        launched = [cg_launches(ran, slam.config.pgo) for ran in o["stats"].cg_iterations]
        check(o["stats"].cg_launched == sum(launched),
              f"back end: {o['stats'].cg_launched} CG iterations launched, as the chunks of "
              f"{backend.CG_CHECK_EVERY} give for {o['stats'].cg_iterations}")
        out["scatter_add"] += sum(2 + n for n in launched)
    return out


def profile_once(fn):
    """The device events of one run of ``fn()``. The device's activity only:
    a window holds ~225,000 kernels, and the host's op events would double
    what the profiler must parse."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def slam_profile(cfg, make_odometry, scans: np.ndarray, window_end: int) -> dict:
    """A second drive of the same pipeline, profiled over the
    ``SLAM_PROFILE_FRAMES`` frames that end at ``window_end``."""
    slam = pipeline.SLAM(cfg, odometry=make_odometry())
    slam.init()
    w0 = max(0, window_end - SLAM_PROFILE_FRAMES)
    for t in range(w0):
        slam.process_next_frame(scans[t])
    opts = len(slam.optimizations)
    subs = slam.loop_closure.stats.submaps
    profile_once(lambda: torch.ones(8, device="cuda").sum())  # the tracer warm
    device = profile_once(lambda: [slam.process_next_frame(scans[t])
                                   for t in range(w0, window_end)])
    prof = summarize_device_events(device)
    frames = window_end - w0
    return {"window_frames": [w0, window_end],
            "window_optimizations": len(slam.optimizations) - opts,
            "window_submaps": slam.loop_closure.stats.submaps - subs,
            "device_ms_per_frame": prof["device_ms"] / frames,
            "launches_per_frame": prof["device_launches"] / frames,
            "idle_share": prof["idle_share"],
            "device_ms_by_port_kernel": prof["device_ms_by_port_kernel"],
            "top_kernels": prof["top_kernels"][:8]}


def slam_drive(label: str, cfg, make_odometry, scans: np.ndarray, gt: np.ndarray,
               log_dir: str, fused=None) -> dict:
    """Drive one SLAM composition through ``SLAMRunner`` with the launch
    counters zeroed just before and read just after; check the launch
    counts, the poses and the result files; then profile a window."""
    runner = runner_mod.SLAMRunner(runner_mod.SLAMRunnerConfig(
        slam=cfg, log_dir=log_dir, fail_on_error=True), odometry=make_odometry())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    md = runner.run({label: _Frames(scans, gt)})[label]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    slam = runner.pipelines[label]
    forwards = len(scans) - 1 if fused is not None else 0
    expected = expected_slam_launches(slam, forwards, bool(fused))
    check(counts == expected, f"{label}: launches {counts} are the path's {expected}")
    if fused is None:
        # ICP closes loops here; the deep front end's untrained weights do not
        # (its trajectory leaves the 30 m gate), and 0 refinements is then exact
        check(counts["knn"] > 0 and counts["gather"] > 0 and counts["scatter_add"] > 0,
              f"{label}: the masked kNN, the refine's gather and the back end's scatter-add ran")
    poses = slam.absolute_poses()
    check(poses.shape == (len(scans), 4, 4) and is_se3(poses), f"{label}: poses finite SE(3)")
    for name in (f"{label}.poses.txt", f"{label}_gt.poses.txt", "metrics.yaml"):
        check(Path(log_dir, name).exists(), f"{label}: {name} written")
    lcs = slam.loop_closure.stats
    opts = slam.optimizations
    odo_reads = (sum(slam.odometry.host_reads) if hasattr(slam.odometry, "host_reads")
                 else forwards)  # the deep front end fetches each pose once
    pgo_reads = sum(o["stats"].host_reads + 1 for o in opts)  # + the resync's read
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    out = {
        "seconds": seconds, "frames": len(scans),
        "ms_per_frame_median": 1e3 * statistics.median(slam.elapsed),
        "ms_per_frame_mean": 1e3 * statistics.mean(slam.elapsed),
        "submaps": lcs.submaps, "candidates": lcs.candidates, "refinements": lcs.refinements,
        "constraints": lcs.accepted,
        "ms_per_submap_median": 1e3 * statistics.median(lcs.submap_seconds),
        "ms_per_submap_max": 1e3 * max(lcs.submap_seconds),
        "optimizations": len(opts),
        "ms_per_optimization": [1e3 * o["seconds"] for o in opts],
        "gn_iterations": [o["stats"].gn_iterations for o in opts],
        "cg_iterations": [o["stats"].cg_iterations for o in opts],
        "cg_launched": [o["stats"].cg_launched for o in opts],
        "host_reads_per_optimization": [o["stats"].host_reads + 1 for o in opts],
        "host_reads_per_frame": (odo_reads + lcs.host_reads + pgo_reads) / len(scans),
        "host_reads": {"odometry": odo_reads, "loop_closure": lcs.host_reads, "backend": pgo_reads},
        "launches": counts, "peak_memory_bytes": peak,
        "ate_m": float(err.mean()), "final_error_m": float(err[-10:].mean()),
        "metrics": {k: v for k, v in (md or {}).items() if isinstance(v, float)},
    }
    window_end = opts[0]["nodes"] if opts else len(scans)
    out["profile"] = slam_profile(cfg, make_odometry, scans, window_end)
    out["_slam"] = slam
    log(f"{label}: {out['ms_per_frame_median']:.1f} ms a frame (median), "
        f"{out['ms_per_submap_median']:.1f} ms a submap, {len(opts)} optimizations "
        f"({[round(x, 1) for x in out['ms_per_optimization']]} ms, GN {out['gn_iterations']}), "
        f"{lcs.accepted} constraints of {lcs.refinements} refinements, "
        f"{out['host_reads_per_frame']:.2f} host reads a frame, device "
        f"{out['profile']['device_ms_per_frame']:.2f} ms and "
        f"{out['profile']['launches_per_frame']:.0f} launches a frame, idle "
        f"{out['profile']['idle_share']:.3f}, peak {peak / 2**20:.0f} MiB, "
        f"final error {out['final_error_m']:.3f} m")
    return out


def slam_card_vs_cpu(lc, builder) -> dict:
    """``_refine_icp`` on a submap pair that closed a loop (the card's
    registration as the start) and ``optimize`` on a 200-node circle with
    loop edges, each on the card and on the CPU from one state; then the
    graph of ``builder`` (slam-icp-loop's, at the default capacity) twice
    on the card, bit for bit."""
    c = lc.constraints[0]
    old = next(s for s in lc.submaps if s.mid_frame_id == c.frame_i)
    new = next(s for s in lc.submaps if s.mid_frame_id == c.frame_j)
    args = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in (new.points, new.mask, old.points, old.mask)]
    cuda_args = [a.cuda() for a in args]
    reg = register_bev(cuda_args[2], cuda_args[3], cuda_args[0], cuda_args[1], lc.config.bev)
    init = planar_to_pose(reg).cpu()
    with icp.full_fp32_products():
        card = loop_closure._refine_icp(lc.config, *cuda_args, init.cuda())
    cpu = loop_closure._refine_icp(lc.config, *args, init)
    pa, pb = card[0].cpu().numpy(), cpu[0].numpy()
    refine = {"shape": f"{new.points.shape[0]} against {old.points.shape[0]} points",
              "trans_gap_m": float(np.abs(pa[:3, 3] - pb[:3, 3]).max()),
              "rot_gap_rad": icp_rotation_gap(pa, pb),
              "rmse": [float(card[1]), float(cpu[1])]}
    check(refine["trans_gap_m"] <= SLAM_CARD_CPU_ATOL and refine["rot_gap_rad"] <= SLAM_CARD_CPU_ATOL,
          f"refine card vs CPU: {refine['trans_gap_m']:.3g} m, {refine['rot_gap_rad']:.3g} rad "
          f"<= {SLAM_CARD_CPU_ATOL}; RMSE {refine['rmse']}")
    check(abs(refine["rmse"][0] - refine["rmse"][1]) <= SLAM_CARD_CPU_ATOL,
          "refine card vs CPU: RMSE within 1e-4")

    b = circle_graph(capacity=(256, 512, 8))
    cfg = backend.PGOConfig()
    graphs = {"card": b.to_device(), "cpu": b.to_device(device="cpu")}
    outs = {k: backend.optimize(g, cfg).poses.cpu().numpy() for k, g in graphs.items()}
    pose_gap = float(np.abs(outs["card"] - outs["cpu"]).max())
    cost = {k: (float(backend.graph_cost(g)), float(backend.graph_cost(g, torch.from_numpy(
        outs[k]).to(g.poses.device)))) for k, g in graphs.items()}
    factor = {k: before / after for k, (before, after) in cost.items()}
    check(pose_gap <= SLAM_CARD_CPU_ATOL, f"optimize card vs CPU, 200-node circle: pose gap "
          f"{pose_gap:.3g} <= {SLAM_CARD_CPU_ATOL}")
    check(abs(factor["card"] - factor["cpu"]) <= PGO_COST_RTOL * factor["cpu"],
          f"optimize: the cost falls by {factor['card']:.6g} on the card and {factor['cpu']:.6g} "
          f"on the CPU (within {PGO_COST_RTOL} relative)")
    full = builder.to_device()
    runs, times, stats = [], [], []
    for _ in range(2):
        st = backend.PGOStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(backend.optimize(full, cfg, st).poses)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        stats.append(st)
    check(torch.equal(runs[0], runs[1]), f"optimize slam-icp-loop's graph ({len(builder.poses)} "
          "nodes, default capacity) twice on the card: bit-identical poses")
    return {"refine": refine, "pgo_pose_gap": pose_gap, "pgo_cost_factor": factor,
            "pgo_twice_nodes": len(builder.poses), "pgo_twice_ms": times,
            "pgo_twice_gn": stats[0].gn_iterations, "pgo_twice_cg": stats[0].cg_iterations,
            "pgo_twice_host_reads": stats[0].host_reads}


def circle_graph(n: int = 200, radius: float = 20.0, capacity=(256, 512, 8)):
    """tests/pgo_fixtures.py's circle with drifted odometry (noise 0.02 m /
    0.002 rad), a loop edge from the last node to the first and four across
    the circle."""
    gt = np.tile(np.eye(4), (n, 1, 1))
    for t in range(n):
        a = 2 * np.pi * t / n
        gt[t, :3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        gt[t, :3, 3] = [radius * np.sin(a), radius * (1 - np.cos(a)), 0]
    rng = np.random.default_rng(0)
    b = backend.PoseGraphBuilder(*capacity)
    pose = gt[0]
    b.add_node(pose)
    for t in range(1, n):
        noise = np.concatenate([rng.normal(scale=0.02, size=3), rng.normal(scale=0.002, size=3)])
        rel = np.linalg.inv(gt[t - 1]) @ gt[t] @ se3.exp(torch.from_numpy(noise)).numpy()
        pose = pose @ rel
        b.add_node(pose)
        b.add_odometry_edge(t - 1, rel)
    for i, j in ((0, n - 1), (0, n // 2), (n // 8, 5 * n // 8), (n // 4, 3 * n // 4),
                 (3 * n // 8, 7 * n // 8)):
        b.add_loop_edge(i, j, np.linalg.inv(gt[i]) @ gt[j])
    return b


def drift_phase() -> dict:
    """The reference's drift scenario on the card, backend off and on, held
    to tests/test_pipeline.py::test_loop_backend_reduces_drift's gates; the
    absolute one to the reference's spread (DRIFT_REFERENCE_SPREAD), and the
    error anchored at frame 1 to 0.5 m."""
    t0 = time.perf_counter()
    slam_off, err_off = drift_injection.run_drift_scenario(with_backend=False)
    slam_on, err_on = drift_injection.run_drift_scenario(with_backend=True)
    gt = drift_injection.scenario_ground_truth()
    anchored = {label: drift_injection.anchored_errors(slam.absolute_poses(), gt, DRIFT_ANCHOR)
                for label, slam in (("on", slam_on), ("off", slam_off))}
    final_off, final_on = float(err_off[-10:].mean()), float(err_on[-10:].mean())
    final_on_anchored = float(anchored["on"][-10:].mean())
    n_on = len(slam_on.loop_closure.constraints)
    log(f"drift scenario: {n_on} loop constraints; final 10-frame error {final_on:.3f} m with "
        f"the back end ({final_on_anchored:.3f} m anchored at frame {DRIFT_ANCHOR}; the first "
        f"step's error {err_on[1]:.3f} m), {final_off:.3f} m without")
    log(f"drift scenario: the reference's absolute gate as it states it, final_on < 0.5 m, is "
        f"{'met' if final_on < 0.5 else 'not met'} ({final_on:.3f} m)")
    check(n_on >= 1, "drift scenario: at least one loop constraint")
    check(final_on < 0.5 * final_off, "drift scenario: final_on < 0.5 x final_off")
    check(final_off > 1.0, "drift scenario: final_off > 1.0 m (the scenario drifts)")
    check(final_on <= DRIFT_REFERENCE_SPREAD,
          f"drift scenario: final_on <= {DRIFT_REFERENCE_SPREAD} m, the reference's largest over "
          f"its nudged scans, their projection in float64")
    check(final_on_anchored < 0.5,
          f"drift scenario: final_on < 0.5 m, anchored at frame {DRIFT_ANCHOR}")
    return {"final_on_m": final_on, "final_off_m": final_off, "constraints_on": n_on,
            "final_on_anchored_m": final_on_anchored,
            "final_off_anchored_m": float(anchored["off"][-10:].mean()),
            "error_on_m": err_on.tolist(), "error_off_m": err_off.tolist(),
            "constraints_off": len(slam_off.loop_closure.constraints),
            "optimizations_on": len(slam_on.optimizations),
            "seconds": time.perf_counter() - t0, "loop_closure": slam_on.loop_closure}


def slam_cli_drive(ckpt_dir: str, out_dir: str) -> dict:
    """``run_slam_torch.py`` at config/kitti_pwclonet_backend.yaml on the
    80-frame synthetic sequence: the KITTI gates find no loop in 80 frames,
    so the drive runs the front end, the frames' sampling and one submap."""
    argv = ["config=kitti_pwclonet_backend", "dataset=synthetic", "sequences=5",
            f"synthetic_frames={SLAM_FRAMES}", "synthetic_trajectory=there_and_back",
            f"checkpoint_dir={ckpt_dir}", f"log_dir={out_dir}"]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = run_slam_torch.main(argv)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    forwards = SLAM_FRAMES - 1
    expected = {name: n * forwards for name, n in LAUNCHES_PER_FORWARD[True].items()}
    check(rc == 0, "run_slam_torch.py config=kitti_pwclonet_backend exits 0")
    check(counts == expected, f"run_slam_torch.py: launches {counts} are the fused front end's "
          f"per-frame counts x {forwards} forwards")
    poses = read_poses_txt(str(Path(out_dir, "synth05.poses.txt")))
    check(poses.shape == (SLAM_FRAMES, 4, 4) and is_se3(poses),
          "run_slam_torch.py: poses written, finite SE(3)")
    check(Path(out_dir, "metrics.yaml").exists() and Path(out_dir, "config.yaml").exists(),
          "run_slam_torch.py: metrics.yaml and config.yaml written")
    return {"argv": argv, "seconds": time.perf_counter() - t0, "launches": counts}


def slam_phase(ckpt_dir: str) -> dict:
    """Phase 8: the card against the CPU, the drift scenario, then the two
    SLAM compositions at full width through SLAMRunner, and the CLI."""
    t0 = time.perf_counter()
    out = {}
    log("phase 8: the drift scenario, backend off and on")
    drift = drift_phase()
    log(f"generating the {SLAM_FRAMES}-frame there-and-back sequence at 8192 points")
    scans, gt = slam_sequence()
    fused_cfg = DeepOdometryConfig(model=PWCLONetConfig(fused_eval=True))
    ckpt = str(sorted(Path(ckpt_dir, "checkpoints").glob("step_*.pt"))[-1])
    with tempfile.TemporaryDirectory() as work:
        log("phase 8: slam-icp-loop at full width through SLAMRunner")
        out["slam-icp-loop"] = slam_drive(
            "slam-icp-loop", slam_config(), lambda: icp.ICPOdometry(icp.ICPConfig(num_points=8192)),
            scans, gt, str(Path(work, "icp")))
        log("phase 8: slam-pwclonet-loop (the fused front end from the checkpoint)")
        out["slam-pwclonet-loop"] = slam_drive(
            "slam-pwclonet-loop", slam_config(), lambda: PWCLONetOdometry(ckpt, fused_cfg),
            scans, gt, str(Path(work, "pwclonet")), fused=True)
        log("phase 8: run_slam_torch.py config=kitti_pwclonet_backend")
        out["cli"] = slam_cli_drive(ckpt_dir, str(Path(work, "cli")))
    log("phase 8: the card against the CPU from one state")
    # a submap pair of the full-width run that closed a loop, else the drift
    # scenario's
    icp_slam = out["slam-icp-loop"].pop("_slam")
    out["slam-pwclonet-loop"].pop("_slam")
    drift_lc = drift.pop("loop_closure")
    lc = icp_slam.loop_closure if icp_slam.loop_closure.constraints else drift_lc
    out["card_vs_cpu"] = slam_card_vs_cpu(lc, icp_slam.builder)
    out["drift"] = drift
    out["seconds"] = time.perf_counter() - t0
    out["configs"] = {
        "slam-icp-loop": "config/kitti_loop_backend.yaml: ICPConfig() at 8192 points, "
                         "LoopClosureConfig() widths, back end 8192/16384/256, PGOConfig()",
        "slam-pwclonet-loop": "config/kitti_pwclonet_backend.yaml: PWCLONetConfig(fused_eval=True) "
                              "at 8192 points from the phase-5 checkpoint, the same loop closure "
                              "and back end",
        "reduced": f"{SLAM_FRAMES} frames (there and back, speed 1.6, seed 5); "
                   f"loop gates {SLAM_LOOP_REDUCED} (KITTI: 50 / 20 / 200 / 100)",
    }
    return out


# ---------------------------------------------------------------------------
# Phase 9: CT-ICP, elastic and rigid, at full width (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------

# config/kitti_ct_icp.yaml (odometry=ct_icp) and its rigid twin: 8192
# points, a 64x720 map, 20 keyframes, 15 alignments, the gate from 4.0 to
# 0.5 m, Huber 0.1, the three CT-ICP priors at beta 0.003
CT_CONFIGS = {
    "ct-icp": ct_icp.CTICPConfig(num_points=8192),
    "ct-icp-rigid": ct_icp.CTICPConfig(num_points=8192, elastic=False),
}
# tests/test_ct_icp.py's motion (curve, 2.5 m and 2 deg a frame, seed 3,
# rolling shutter) over 32 frames, in the along-path world: the corridor
# world ends after ~70 m of a curving path, and this one runs 77.5 m
CT_FRAMES = 32
CT_CARRY_FRAMES = 8  # card against CPU: one step from the card's state after 8 frames
# one step card against CPU: the same ops on other hardware move the pose by
# ~1e-7 unless a match flips; where the port's own step on the card moves by
# more under a one-ulp nudge of its state's poses and scan, 3x that
CT_STEP_ATOL = 1e-4
# the final drift of the elastic run against ground truth. The JAX reference
# on these scans (this generator, 8192 points, CTICPConfig()) on the CPU gave
# 0.4520 m, and on the scans moved by one float32 ulp up and down 0.4015 and
# 0.3994 m; the bound is 1.5x the worst of the three. Its rigid mode gave
# 0.9715 m (0.8781, 0.9899) and projective ICP 0.9673 m: the elastic run
# must also beat projective ICP, tests/test_ct_icp.py's own gate
CT_REFERENCE_DRIFT_M = (0.4520, 0.4015, 0.3994)
CT_DRIFT_BOUND_M = 1.5 * max(CT_REFERENCE_DRIFT_M)
CT_TF32_POSE_ATOL = 1e-6


def ct_sequence():
    return generate_sequence_with_times(SyntheticSequenceConfig(
        n_frames=CT_FRAMES, trajectory="curve", speed=2.5, yaw_rate_deg=2.0, seed=3,
        motion_distortion=True, world="along_path"))


def _ct_state_to(state, device):
    return state._replace(
        map=type(state.map)(*(x.to(device) for x in state.map)),
        **{f: getattr(state, f).to(device) for f in state._fields
           if f not in ("map", "frame_idx")})


def _nudged_ct_state(state, direction: float):
    def nudge(x):
        return torch.where(x != 0, torch.nextafter(x, torch.full_like(x, direction)), x)

    return state._replace(end_pose=nudge(state.end_pose), last_rel=nudge(state.last_rel),
                          map=state.map._replace(poses=nudge(state.map.poses)))


def ct_card_vs_cpu(scans, times) -> dict:
    """One elastic step from the card's state after CT_CARRY_FRAMES frames,
    on the card and on the CPU; and the card's own one-ulp sensitivity."""
    cfg = CT_CONFIGS["ct-icp"]
    odo = ct_icp.CTICPOdometry(cfg, device="cuda")
    odo.init()
    odo.process_sequence(scans[:CT_CARRY_FRAMES], times[:CT_CARRY_FRAMES])
    st = odo.state
    pts, ts = torch.from_numpy(scans[CT_CARRY_FRAMES]), torch.from_numpy(times[CT_CARRY_FRAMES])
    _, card = ct_icp.process_frame(cfg, st, pts.cuda(), ts.cuda())
    _, cpu = ct_icp.process_frame(cfg, _ct_state_to(st, "cpu"), pts, ts)
    sens = 0.0
    for direction in (math.inf, -math.inf):
        moved = torch.where(pts != 0, torch.nextafter(pts, torch.full_like(pts, direction)), pts)
        _, r = ct_icp.process_frame(cfg, _nudged_ct_state(st, direction), moved.cuda(), ts.cuda())
        sens = max(sens, *(float((getattr(r, f) - getattr(card, f)).abs().max())
                           for f in ("pose", "begin_pose")))
    gaps = {f: (float((getattr(card, f).cpu() - getattr(cpu, f))[:3, 3].abs().max()),
                icp_rotation_gap(getattr(card, f).cpu().numpy(), getattr(cpu, f).numpy()))
            for f in ("pose", "begin_pose")}
    bound = max(CT_STEP_ATOL, 3.0 * sens)
    log(f"CT-ICP: card vs CPU one step: end {gaps['pose'][0]:.3g} m / {gaps['pose'][1]:.3g} rad, "
        f"begin {gaps['begin_pose'][0]:.3g} m / {gaps['begin_pose'][1]:.3g} rad; the card's "
        f"own one-ulp sensitivity {sens:.3g}; matches {float(card.num_matches):.0f} / "
        f"{float(cpu.num_matches):.0f}")
    check(all(t <= bound and r <= bound for t, r in gaps.values()),
          f"CT-ICP: card and CPU steps from one state, begin and end pose within {bound:.3g} "
          f"(m and rad; max of {CT_STEP_ATOL} and 3x the card's one-ulp sensitivity)")
    return {"end_gap_m_rad": gaps["pose"], "begin_gap_m_rad": gaps["begin_pose"],
            "one_ulp_sensitivity": sens, "bound": bound,
            "num_matches": [float(card.num_matches), float(cpu.num_matches)]}


def ct_tf32_check(scans, times) -> dict:
    """One full-width elastic step with the TF32 switches off, then on
    globally: the step sets its own precision."""
    cfg = CT_CONFIGS["ct-icp"]
    odo = ct_icp.CTICPOdometry(cfg, device="cuda")
    odo.init()
    odo.process_sequence(scans[:4], times[:4])
    pts, ts = torch.from_numpy(scans[4]).cuda(), torch.from_numpy(times[4]).cuda()
    poses = {}
    for tf32 in (False, True):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            poses[tf32] = ct_icp.process_frame(cfg, odo.state, pts, ts)[1].pose.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    gap = float(np.abs(poses[True] - poses[False]).max())
    check(gap <= CT_TF32_POSE_ATOL,
          f"CT-ICP: a step under global TF32 gives the same pose ({gap:.3g} <= {CT_TF32_POSE_ATOL})")
    return {"tf32_on_pose_gap": gap}


def ct_accuracy(scans, times, gt) -> dict:
    """Final drift (m, and over the path length) of elastic, rigid and
    projective ICP on the same scans; elastic held to CT_DRIFT_BOUND_M."""
    path_m = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1).sum())
    out = {"path_m": path_m}
    runs = {label: ct_icp.CTICPOdometry(cfg, device="cuda") for label, cfg in CT_CONFIGS.items()}
    runs["icp-projective"] = icp.ICPOdometry(ICP_CONFIGS["projective"], device="cuda")
    for label, odo in runs.items():
        odo.init()
        if label.startswith("ct"):
            odo.process_sequence(scans, times)
        else:
            odo.process_sequence(scans)
        pred = odo.absolute_poses()
        drift = float(np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3]))
        check(is_se3(pred), f"{label}: {CT_FRAMES} finite SE(3) poses")
        out[label] = {"final_drift_m": drift, "drift_over_path": drift / path_m}
    log("CT-ICP drift over the 32 distorted frames: " + ", ".join(
        f"{k} {v['final_drift_m']:.4f} m" for k, v in out.items() if k != "path_m"))
    check(out["ct-icp"]["final_drift_m"] <= CT_DRIFT_BOUND_M,
          f"CT-ICP elastic: final drift <= {CT_DRIFT_BOUND_M:.4f} m (1.5x the JAX reference's "
          f"worst over the scans and their one-ulp nudges)")
    check(out["ct-icp"]["final_drift_m"] < out["icp-projective"]["final_drift_m"],
          "CT-ICP elastic drifts less than projective ICP on the distorted scans")
    return out


def ct_timing(label: str, scans, times) -> dict:
    """ms a frame of process_next_frame (median after the first) and of
    process_sequence, device ms, launches and idle share a frame over a
    profiled stretch of 4 frames, GN iterations and host reads a frame, peak
    memory."""
    cfg = CT_CONFIGS[label]
    odo = ct_icp.CTICPOdometry(cfg, device="cuda")
    odo.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    for scan, ts in zip(scans, times):
        t0 = time.perf_counter()
        odo.process_next_frame(scan, ts)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    iters, reads = list(odo.iterations), list(odo.host_reads)
    peak = torch.cuda.max_memory_allocated()
    seq_ms = []
    for _ in range(2):
        odo.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odo.process_sequence(scans, times)  # ends in a device-to-host copy
        seq_ms.append(1e3 * (time.perf_counter() - t0) / len(scans))
    odo.init()
    odo.process_sequence(scans[:8], times[:8])
    st0 = odo.state
    dev_scans, dev_times = torch.from_numpy(scans[8:12]).cuda(), torch.from_numpy(times[8:12]).cuda()

    def stretch():
        st = st0
        for t in range(4):
            st, _ = ct_icp.process_frame(cfg, st, dev_scans[t], dev_times[t])

    _, device = profile_device_events(stretch)
    prof = summarize_device_events(device)
    out = {
        "process_next_frame_ms_median": statistics.median(frame_ms[1:]),
        "process_sequence_ms_per_frame": statistics.median(seq_ms),
        "process_sequence_ms_per_frame_runs": seq_ms,
        "device_ms_per_frame": prof["device_ms"] / 4, "launches_per_frame": prof["device_launches"] / 4,
        "idle_share": prof["idle_share"],
        "gn_iterations_per_frame": statistics.mean(iters),
        "host_reads_per_frame": statistics.mean(reads), "peak_memory_bytes": peak,
        "top_kernels": prof["top_kernels"][:6],
    }
    log(f"{label}: process_next_frame {out['process_next_frame_ms_median']:.2f} ms/frame, "
        f"process_sequence {out['process_sequence_ms_per_frame']:.2f} ms/frame, device "
        f"{out['device_ms_per_frame']:.3f} ms and {out['launches_per_frame']:.0f} launches a "
        f"frame, idle {out['idle_share']:.3f}, {out['gn_iterations_per_frame']:.2f} GN iterations "
        f"and {out['host_reads_per_frame']:.2f} host reads a frame, peak {peak / 2**20:.0f} MiB")
    return out


def ct_cli_drive(out_dir: str) -> dict:
    """run_slam_torch.py odometry=ct_icp on a synthetic sequence with loop
    closure and the back end on."""
    frames = 40
    argv = ["odometry=ct_icp", "dataset=synthetic", "sequences=5", f"synthetic_frames={frames}",
            "with_loop_closure=true", "with_backend=true", f"log_dir={out_dir}"]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = run_slam_torch.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, "run_slam_torch.py odometry=ct_icp with loop closure and back end exits 0")
    poses = read_poses_txt(str(Path(out_dir, "synth05.poses.txt")))
    check(poses.shape == (frames, 4, 4) and is_se3(poses),
          "run_slam_torch.py odometry=ct_icp: poses written, finite SE(3)")
    return {"argv": argv, "seconds": seconds, "ms_per_frame": 1e3 * seconds / frames,
            "launches": _cuda.launch_counts()}


def ct_icp_phase() -> dict:
    t0 = time.perf_counter()
    log(f"generating the {CT_FRAMES}-frame motion-distorted curve at 8192 points")
    scans, times, gt = ct_sequence()
    out = {"sequence_gen_s": time.perf_counter() - t0,
           "configs": {k: repr(v) for k, v in CT_CONFIGS.items()}}
    _cuda.reset_launch_counts()
    out["card_vs_cpu"] = ct_card_vs_cpu(scans, times)
    out["tf32"] = ct_tf32_check(scans, times)
    out["accuracy"] = ct_accuracy(scans, times, gt)
    for label in CT_CONFIGS:
        out[label] = ct_timing(label, scans, times)
    check(all(v == 0 for v in _cuda.launch_counts().values()),
          "CT-ICP launched none of the point-op kernels (plain PyTorch)")
    with tempfile.TemporaryDirectory() as work:
        out["cli"] = ct_cli_drive(work)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 10: PoseResNet odometry and training at full width (cuDNN, no kernel)
# ---------------------------------------------------------------------------

# config/train_posenet.yaml and config/kitti_posenet.yaml: ResNet-18 over
# 64x720 vertex-map pairs, batch 8, Adam at 1e-4, supervised
PN_BATCH = 8
PN_STEPS = 6
PN_UNSUP_STEPS = 2
PN_FRAMES = 10
PN_SMALL = (16, 64)
# card against CPU at 16x64, TF32 off: the same convolutions summed in
# another order (cuDNN against oneDNN)
PN_PARAMS_ATOL, PN_PARAMS_RTOL = 1e-4, 1e-3
PN_CHAIN_ATOL = 1e-4  # per frame against process_sequence, over 9 chained poses


def pn_pairs(n_frames: int, seed: int = 0) -> tuple:
    """Vertex-map pairs at 64x720 of a synthetic corridor sequence."""
    scans, gt = generate_sequence(SyntheticSequenceConfig(n_frames=n_frames, seed=seed))
    ds = vm_pairs.VertexMapPairDataset.from_scans(scans, gt, SphericalProjector(),
                                                  num_points=scans.shape[1])
    return scans, ds


def pn_small_card_vs_cpu() -> dict:
    """16x64, ResNet-18 from one seed on both: eval and train forward, and
    the train-mode loss and gradients, TF32 off."""
    h, w = PN_SMALL
    proj = SphericalProjector(height=h, width=w)
    scans, gt = generate_sequence(SyntheticSequenceConfig(n_frames=3, num_points=2048, seed=1))
    batch = next(vm_pairs.VertexMapPairDataset.from_scans(scans, gt, proj, num_points=2048)
                 .batches(2, shuffle=False))
    cfg = pn_state.PoseNetTrainConfig(projector=proj)
    states = {d: pn_state.create_posenet_train_state(cfg, seed=0, device=d) for d in ("cuda", "cpu")}
    frames = torch.from_numpy(np.stack([batch["vm1"], batch["vm2"]], axis=1))
    out = {}
    with posenet.conv_precision(), torch.no_grad():
        for mode in (False, True):
            a = states["cuda"].model(frames.cuda(), train=mode).cpu()
            b = states["cpu"].model(frames, train=mode)
            discard_batch_stats(states["cuda"].model)
            discard_batch_stats(states["cpu"].model)
            out["train" if mode else "eval"] = float((a - b).abs().max())
            check(torch.allclose(a, b, atol=PN_PARAMS_ATOL, rtol=PN_PARAMS_RTOL),
                  f"PoseResNet 16x64 {'train' if mode else 'eval'} forward card vs CPU within "
                  f"atol {PN_PARAMS_ATOL} / rtol {PN_PARAMS_RTOL}")
    grads = {}
    losses = {}
    for d, st in states.items():
        losses[d], _, grads[d] = pn_state.posenet_loss_and_grads(cfg, st, batch)
    worst = 0.0
    for k, g in grads["cpu"].items():
        gap = float((grads["cuda"][k].cpu() - g).abs().max())
        worst = max(worst, gap / (1e-4 + 1e-3 * float(g.abs().max())))
    check(abs(float(losses["cuda"]) - float(losses["cpu"])) <= 1e-5 * abs(float(losses["cpu"])),
          "PoseResNet 16x64 loss card vs CPU within rtol 1e-5")
    check(worst <= 1.0, "PoseResNet 16x64 gradients card vs CPU: every leaf within atol "
          "1e-4 + 1e-3 of the leaf's largest magnitude")
    out.update(loss=[float(losses["cuda"]), float(losses["cpu"])], grad_gap_over_tolerance=worst)
    log(f"PoseResNet 16x64 card vs CPU: eval {out['eval']:.3g}, train {out['train']:.3g}, "
        f"gradients at {worst:.3f} of their tolerance")
    return out


def pn_train(ds, log_dir: str) -> dict:
    """PN_STEPS supervised steps through PoseNetTrainer.train_epoch, the
    same step twice from one state (identical gradients), PN_UNSUP_STEPS
    unsupervised steps; the step times in fp32 and TF32."""
    trainer = posenet_trainer.PoseNetTrainer(posenet_trainer.PoseNetTrainerConfig(
        log_dir=log_dir, steps_per_dispatch=PN_STEPS))
    order = np.random.default_rng(0).permutation(len(ds))
    batches = [ds[int(i)] for i in order[:PN_BATCH]]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    blocks = [batch] * PN_STEPS
    t0 = time.perf_counter()
    trainer.train_epoch(blocks)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    logs = trainer.last_epoch_logs
    check(len(logs["loss"]) == PN_STEPS and np.all(np.isfinite(logs["loss"]))
          and np.all(np.isfinite(logs["grad_norm"])) and not logs["skipped_nonfinite"].any(),
          f"PoseNet: {PN_STEPS} supervised steps, losses and gradient norms finite, none skipped")
    cfg, st = trainer.config.train, trainer.state
    g1 = pn_state.posenet_loss_and_grads(cfg, st, batch)[2]
    discard_batch_stats(st.model)
    g2 = pn_state.posenet_loss_and_grads(cfg, st, batch)[2]
    discard_batch_stats(st.model)
    check(all(torch.equal(g1[k], g2[k]) for k in g1),
          "PoseNet: the same step from one state twice gives bit-identical gradients")
    ckpt = trainer.save_checkpoint("smoke")
    # times: CUDA events around whole steps, fp32 then TF32
    times = {}
    for tf32 in (False, True):
        tcfg = dataclasses.replace(cfg, tf32=tf32)
        pn_state.posenet_train_step(tcfg, st, batch)  # warm
        runs = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            pn_state.posenet_train_step(tcfg, st, batch)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        times["tf32" if tf32 else "fp32"] = {"train_step_ms": statistics.median(runs),
                                             "runs": runs}
    torch.cuda.reset_peak_memory_stats()
    prof, device = profile_device_events(lambda: pn_state.posenet_train_step(cfg, st, batch))
    peak = torch.cuda.max_memory_allocated()
    step_prof = summarize_device_events(device)
    ucfg = pn_state.PoseNetTrainConfig(loss="unsupervised")
    ust = pn_state.create_posenet_train_state(ucfg, seed=0)
    ubatch = {k: v for k, v in batch.items() if k != "gt_pose"}
    ulogs = pn_state.posenet_train_steps(ucfg, ust, {k: np.stack([v] * PN_UNSUP_STEPS)
                                                     for k, v in ubatch.items()})
    ulosses = ulogs["loss"].cpu().numpy()
    check(np.all(np.isfinite(ulosses)) and not ulogs["skipped_nonfinite"].any(),
          f"PoseNet: {PN_UNSUP_STEPS} unsupervised steps, losses finite, none skipped")
    log(f"PoseNet train step at batch {PN_BATCH}, 64x720: fp32 {times['fp32']['train_step_ms']:.2f} "
        f"ms, TF32 {times['tf32']['train_step_ms']:.2f} ms; {step_prof['device_launches']} device "
        f"launches, idle {step_prof['idle_share']:.3f}, peak {peak / 2**20:.0f} MiB")
    return {"epoch_s": epoch_s, "losses": logs["loss"].tolist(),
            "unsupervised_losses": ulosses.tolist(), "times": times,
            "train_pairs_per_s_fp32": PN_BATCH / times["fp32"]["train_step_ms"] * 1e3,
            "step_profile": step_prof, "peak_memory_bytes": peak, "_checkpoint": ckpt}


def pn_odometry(ckpt: str, scans: np.ndarray) -> dict:
    """PoseNetOdometry from the checkpoint over PN_FRAMES frames, per frame
    against process_sequence; the forward at B=1 by CUDA events; one
    profiled forward."""
    a = slam_deep.PoseNetOdometry(ckpt)
    a.init()
    frame_ms = []
    for scan in scans[:PN_FRAMES]:
        t0 = time.perf_counter()
        a.process_next_frame(scan)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    b = slam_deep.PoseNetOdometry(ckpt)
    b.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.process_sequence(scans[:PN_FRAMES])
    seq_ms = 1e3 * (time.perf_counter() - t0) / PN_FRAMES
    gap = float(np.abs(a.absolute_poses() - b.absolute_poses()).max())
    check(is_se3(a.absolute_poses()) and gap <= PN_CHAIN_ATOL,
          f"PoseNetOdometry: finite SE(3) poses, per frame within {PN_CHAIN_ATOL} of "
          f"process_sequence ({gap:.3g})")
    vms = a._project(scans[:2])
    frames = torch.stack([vms[1:], vms[:1]], dim=1)

    def forward():
        with torch.inference_mode(), posenet.conv_precision():
            a.model(frames)

    fwd = time_ms(forward, reps=20)
    _, device = profile_device_events(forward)
    prof = summarize_device_events(device)
    log(f"PoseNetOdometry: forward at B=1 {fwd:.3f} ms ({prof['device_launches']} launches, idle "
        f"{prof['idle_share']:.3f}), process_next_frame {statistics.median(frame_ms[1:]):.2f} ms, "
        f"process_sequence {seq_ms:.2f} ms a frame; per frame vs batched {gap:.3g}")
    return {"forward_ms_b1": fwd, "forward_profile": prof,
            "process_next_frame_ms_median": statistics.median(frame_ms[1:]),
            "process_sequence_ms_per_frame": seq_ms, "per_frame_vs_batched_gap": gap}


def pn_cli_drive(work: str) -> dict:
    """train_net_torch.py --model posenet --do_train, then --do_test, on
    dataset=synthetic at 64x720; run_slam_torch.py odometry=posenet from that
    checkpoint."""
    log_dir, run_dir = str(Path(work, "train")), str(Path(work, "run"))
    common = ["--model", "posenet", "--dataset", "synthetic", "--log_dir", log_dir]
    t0 = time.perf_counter()
    rc = train_net_torch.main(common + ["--do_train", "--num_epochs", "1", "--synthetic_batches",
                                        "2"])
    check(rc == 0, "train_net_torch.py --model posenet --do_train exits 0")
    rc = train_net_torch.main(common + ["--do_test", "--test_sequences", "9"])
    check(rc == 0 and Path(log_dir, "test", "09.poses.txt").exists()
          and Path(log_dir, "test", "metrics.yaml").exists(),
          "train_net_torch.py --model posenet --do_test exits 0 and writes the result files")
    frames = 20
    rc = run_slam_torch.main(["odometry=posenet", f"checkpoint_dir={log_dir}", "dataset=synthetic",
                              "sequences=5", f"synthetic_frames={frames}", f"log_dir={run_dir}"])
    poses = read_poses_txt(str(Path(run_dir, "synth05.poses.txt")))
    check(rc == 0 and poses.shape == (frames, 4, 4) and is_se3(poses),
          "run_slam_torch.py odometry=posenet: poses written, finite SE(3)")
    return {"seconds": time.perf_counter() - t0}


def posenet_phase() -> dict:
    t0 = time.perf_counter()
    out = {"config": "PoseResNetConfig() (ResNet-18, pairs), 64x720 vertex maps, batch "
                     f"{PN_BATCH}, Adam at 1e-4, supervised; seeded random weights"}
    _cuda.reset_launch_counts()
    out["small_card_vs_cpu"] = pn_small_card_vs_cpu()
    scans, ds = pn_pairs(PN_BATCH + 4)
    with tempfile.TemporaryDirectory() as work:
        train = pn_train(ds, str(Path(work, "train")))
        out["odometry"] = pn_odometry(train.pop("_checkpoint"), scans)
        out["train"] = train
        out["cli"] = pn_cli_drive(work)
    check(all(v == 0 for v in _cuda.launch_counts().values()),
          "PoseNet launched none of the point-op kernels (cuDNN convolutions)")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 11: the PointNet++ cls/semseg family (ball query, three-NN
# interpolation, MSG set abstraction, feature propagation) at full width
# ---------------------------------------------------------------------------

CLS_SEG_BATCH = 32  # ClsSegTrainConfig.batch_size, the upstream recipes'
CLS_SEG_STEPS = 6
# label -> (task, plan, points a cloud): the upstream recipes the reference
# ships (models/cls_seg.py): ModelNet40-sized clouds of 1,024 points for
# cls, Indoor3D blocks of 4,096 points x 9 channels for semseg; procedural
# data (SyntheticShapes, 6 classes; SyntheticRooms, 4 classes)
CLS_SEG_CELLS = {
    "cls-ssg": ("cls", cls_seg_models.CLS_SSG, 1024),
    "cls-msg": ("cls", cls_seg_models.CLS_MSG, 1024),
    "semseg-ssg": ("semseg", cls_seg_models.SEM_SSG, 4096),
}
# launches per eval forward and per train step, read off models/pointnet2.py
# and models/cls_seg.py: a sampling SetConvMSG launches FPS 1 and the gather
# 1 for its centres and 1 a scale (the ball grouping; the ball query itself
# is plain PyTorch); the group-all stage none; a FeaturePropagation with
# known points kNN 1 (three_nn, k=3) and gather 1 (three_interpolate). A
# train step adds one scatter-add for each gather whose source needs a
# gradient: the groupings of every stage above the first (the first groups
# xyz and the input's own channels) and every interpolation.
CLS_SEG_LAUNCHES = {
    "cls-ssg": ({"fps": 2, "knn": 0, "gather": 4},
                {"fps": 2, "knn": 0, "gather": 4, "scatter_add": 1}),
    "cls-msg": ({"fps": 2, "knn": 0, "gather": 8},
                {"fps": 2, "knn": 0, "gather": 8, "scatter_add": 3}),
    "semseg-ssg": ({"fps": 4, "knn": 4, "gather": 12},
                   {"fps": 4, "knn": 4, "gather": 12, "scatter_add": 7}),
}
# card against CPU at the tiny plans of tests/test_cls_seg.py (the
# classifier at B=8: its head's BatchNorm over B rows is degenerate at B=2):
# the same ops in other reduction orders (cuBLAS, the BatchNorm sums)
CLS_SEG_SMALL = {
    "cls": (((32, (0.5, 1.0), (8, 16), ((16, 32), (16, 32))), (8, (1.0,), (8,), ((32, 64),)),
             (None, (None,), (None,), ((64, 128),))), 256, 8),
    "semseg": (((32, (0.5,), (8,), ((16, 32),)), (8, (1.0,), (8,), ((32, 64),))), 256, 2),
}
CLS_SEG_LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
CLS_SEG_LOSS_RTOL = 1e-5
CLS_SEG_GRAD_BAR = (1e-4, 1e-3)  # atol + share of the leaf's largest magnitude


def cls_seg_model(task: str, stages, device: str = "cuda", seed: int = 0):
    if task == "cls":
        return cls_seg_models.PointNet2Classification(len(shapes.SHAPE_CLASSES), stages,
                                                      seed=seed, device=device)
    return cls_seg_models.PointNet2Segmentation(4, stages, in_channels=6, seed=seed,
                                                device=device)


def cls_seg_batches(task: str, n_points: int, n_batches: int, batch: int = CLS_SEG_BATCH,
                    seed: int = 0) -> list:
    """Procedural batches as train_net_torch.py draws them (cls augmented)."""
    if task == "cls":
        ds = shapes.SyntheticShapes(num_items=n_batches * batch, num_points=n_points, seed=seed)
    else:
        ds = shapes.SyntheticRooms(num_items=n_batches * batch, num_points=n_points, seed=seed)
    return list(shapes.batches(ds, batch, np.random.default_rng(seed), augment=task == "cls"))


def cls_seg_config(task: str, batch: int = CLS_SEG_BATCH) -> cls_seg_train.ClsSegTrainConfig:
    return cls_seg_train.ClsSegTrainConfig(batch_size=batch, lr_decay=0.7 if task == "cls" else 0.5,
                                           decay_step=2e4 if task == "cls" else 3e5)


def point_targets() -> dict:
    """The CUDA wrappers of FPS, kNN, the gather and the scatter-add, for
    ``recorded_calls``."""
    return {"fps": (tfps, "_furthest_point_sample_cuda",
                    lambda points, npoint, mask: (points.shape[0], points.shape[1], npoint)),
            "knn": (knn_mod, "_knn_cuda",
                    lambda query, ref, k: (query.shape[0], query.shape[1], ref.shape[1], k)),
            **gather_targets(tgather)}


def each_call(targets: dict) -> dict:
    """``targets`` for ``recorded_calls`` with every call its own entry: the
    shape key led by the call's number."""
    counter = iter(range(1 << 30))
    return {kind: (mod, attr, lambda *a, _key=key: (next(counter), _key(*a)))
            for kind, (mod, attr, key) in targets.items()}


def recorded_kernel_cases(calls: dict, label: str) -> dict:
    """Every call that ``recorded_calls(each_call(...))`` recorded, held to
    its plain version on its own inputs (FPS, kNN and the gather
    ``torch.equal``, the scatter-add ``torch.equal`` to its plain version on
    the CPU copy), the first call of each shape timed and weighted by its
    calls at that shape; every fused call measured and timed
    (:func:`fused_call_case`; the caller holds it). ``label`` names the path
    in the messages."""
    cases = {}
    gen = torch.Generator(device="cuda").manual_seed(12)
    by_shape: dict = {}
    for kind, entries in calls.items():
        for (n, shape), (_, args, kwargs) in entries.items():
            if kind in FUSED_TOL:
                shape = n  # every fused call is a case of its own
            if kind in ("fps", "knn"):
                unmasked = kind != "fps" or args[2] is None
                check(unmasked and all(v is None for v in kwargs.values()),
                      f"{label}: the {kind} call is unmasked")
            first = (kind, shape) not in by_shape
            by_shape.setdefault((kind, shape), [0, None])[0] += 1
            if kind == "fps":
                points, npoint, _ = args
                if not first:
                    check(torch.equal(tfps.furthest_point_sample(points, npoint),
                                      tfps.furthest_point_sample_plain(points, npoint)),
                          f"{label}: fps {tuple(points.shape)}->{npoint} equal to plain")
                    continue
                case = fps_case(points, npoint)
            elif kind == "knn":
                query, ref, k = args
                if not first:
                    d, i = knn(query, ref, k)
                    pd, pi = knn_plain(query, ref, k)
                    check(torch.equal(d, pd) and torch.equal(i, pi),
                          f"{label}: knn {tuple(query.shape)} x {tuple(ref.shape)} k={k} "
                          "equal to plain")
                    continue
                case = knn_case(query, ref, k, what=label)
            elif kind == "gather":
                src, idx = args
                if not first:
                    check(torch.equal(tgather.gather_points(src, idx),
                                      tgather.gather_points_plain(src, idx)),
                          f"{label}: gather {tuple(idx.shape)} C={src.shape[2]} bit-exact")
                    continue
                case = gather_case(src, idx)
            elif kind == "scatter_add":
                upd, idx, n = args
                if not first:
                    out = tgather.scatter_add_rows(upd, idx, n)
                    check(torch.equal(out.cpu(), tgather.scatter_add_rows_plain(
                        upd.cpu(), idx.cpu(), n)),
                          f"{label}: scatter_add {tuple(upd.shape)} N={n} equal to the CPU's")
                    continue
                case = scatter_case(gen, idx[..., None], n, upd.shape[2], label, upd=upd)
            else:
                case = fused_call_case(kind, args)  # every fused call checked and timed
            by_shape[(kind, shape)][1] = case
            cases.setdefault(kind, []).append(case)
    for (kind, _), (launches, case) in by_shape.items():
        if case is not None:
            case["launches"] = case.get("launches", 0) + launches
    return cases


def cls_seg_kernel_cases() -> dict:
    """FPS, kNN, the gather and the scatter-add at every call that each
    cell's paths make: one train-mode forward + backward and one eval
    forward at batch 32, one eval forward at B=1 (the CLI's runs have the
    cells' shapes), on the inputs those calls got, held and timed by
    :func:`recorded_kernel_cases`."""
    cases = {"fps": [], "knn": [], "gather": [], "scatter_add": []}
    for label, (task, stages, n_points) in CLS_SEG_CELLS.items():
        cfg = cls_seg_config(task)
        state = cls_seg_train.create_cls_seg_state(cls_seg_model(task, stages), cfg)
        batch = {k: torch.as_tensor(v).cuda()
                 for k, v in cls_seg_batches(task, n_points, 1)[0].items()}
        xyz, feat = cls_seg_train.split_inputs(batch["points"])

        def paths():
            cls_seg_train.cls_seg_loss_and_grads(cfg, state, batch)
            discard_batch_stats(state.model)
            with torch.no_grad():
                state.model(xyz, feat)
                state.model(xyz[:1], None if feat is None else feat[:1])

        calls = recorded_calls(each_call(point_targets()), paths)
        for kind, rows in recorded_kernel_cases(calls, label).items():
            cases[kind] += [{"drive": label, **row} for row in rows]
        del state, calls
        torch.cuda.empty_cache()
    widths = sorted({int(c["shape"].split("C=")[1].split()[0]) for c in cases["gather"]})
    check(any(w > 256 for w in widths),
          f"phase 11 held the gather at widths above 256 ({widths})")
    return cases


def cls_seg_small_card_vs_cpu() -> dict:
    """The tiny plans on the card against the CPU from one seed: eval logits,
    and one train-mode loss and gradients (dropout off)."""
    out = {}
    for task, (plan, n_points, batch) in CLS_SEG_SMALL.items():
        stages = tuple(cls_seg_models.SAStage(*s) for s in plan)
        cpu, gpu = cls_seg_model(task, stages, "cpu", 3), cls_seg_model(task, stages, "cuda", 4)
        gpu.load_state_dict(cpu.state_dict())
        cpu.dropout = gpu.dropout = 0.0
        data = cls_seg_batches(task, n_points, 1, batch=batch, seed=5)[0]
        with torch.no_grad():
            ref = cpu(*cls_seg_train.split_inputs(torch.from_numpy(data["points"])))
            got = gpu(*cls_seg_train.split_inputs(torch.from_numpy(data["points"]).cuda()))
        err = (got.cpu() - ref).abs().max().item()
        check(torch.allclose(got.cpu(), ref, **CLS_SEG_LOGITS_TOL),
              f"{task} small plan: card vs CPU eval logits within {CLS_SEG_LOGITS_TOL} "
              f"(max {err:.3g})")
        cfg = cls_seg_config(task, batch)
        states = [cls_seg_train.create_cls_seg_state(m, cfg) for m in (cpu, gpu)]
        (ref_loss, _, ref_g), (loss, _, g) = [
            cls_seg_train.cls_seg_loss_and_grads(cfg, st, data) for st in states]
        loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        check(loss_err <= CLS_SEG_LOSS_RTOL,
              f"{task} small plan train step: card vs CPU loss within rtol {CLS_SEG_LOSS_RTOL} "
              f"({loss.item():.6f} vs {ref_loss.item():.6f})")
        atol, share = CLS_SEG_GRAD_BAR
        worst = max((a.cpu() - r).abs().max().item() / (atol + share * r.abs().max().item())
                    for a, r in zip(g, ref_g))
        check(worst <= 1.0, f"{task} small plan train step: every gradient leaf within atol "
              f"{atol} + {share} of its largest magnitude (worst at {worst:.3g} of the bar)")
        out[task] = {"eval_logits_max_abs_err": err, "train_loss_rel_err": loss_err,
                     "grad_worst_share_of_bar": worst}
    return out


def cls_seg_drive(label: str) -> dict:
    """One cell at full width, batch 32: the launches of one eval forward and
    one train step (checked exactly), six train steps (finite losses), the
    same step twice from one state (bit-identical gradients), forward ms at
    B=32 and B=1 and train-step ms (CUDA events), one profiled step, peak
    memory."""
    task, stages, n_points = CLS_SEG_CELLS[label]
    cfg = cls_seg_config(task)
    state = cls_seg_train.create_cls_seg_state(cls_seg_model(task, stages), cfg)
    model = state.model
    check(all(p.is_cuda for p in model.parameters()), f"{label}: the model lies on the card")
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in cls_seg_batches(task, n_points, CLS_SEG_STEPS)]
    xyz, feat = cls_seg_train.split_inputs(batches[0]["points"])
    forward_b1 = lambda: model(xyz[:1], None if feat is None else feat[:1])  # noqa: E731
    with torch.no_grad():
        model(xyz, feat)  # warm
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        logits = model(xyz, feat)
        torch.cuda.synchronize()
    fwd_launches = _cuda.launch_counts()
    want_fwd, want_step = CLS_SEG_LAUNCHES[label]
    zeros = {k: 0 for k in _cuda.LAUNCHES}
    check(fwd_launches == {**zeros, **want_fwd},
          f"{label}: one eval forward launched {fwd_launches}")
    want_shape = (CLS_SEG_BATCH, len(shapes.SHAPE_CLASSES)) if task == "cls" else (
        CLS_SEG_BATCH, n_points, 4)
    check(tuple(logits.shape) == want_shape and bool(torch.isfinite(logits).all()),
          f"{label}: eval logits {tuple(logits.shape)} finite")
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        if i == 0:
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(cls_seg_train.cls_seg_train_step(cfg, state, batch)["loss"])
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        if i == 0:
            step_launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(step_launches == {**zeros, **want_step},
          f"{label}: one train step launched {step_launches}")
    losses = torch.stack(losses).cpu().numpy()
    check(len(losses) == CLS_SEG_STEPS and bool(np.all(np.isfinite(losses))),
          f"{label}: {CLS_SEG_STEPS} train steps at batch {CLS_SEG_BATCH}, losses finite "
          f"({', '.join(f'{v:.4f}' for v in losses)})")
    grads = []
    gen_state = state.generator.get_state()
    for _ in range(2):
        state.generator.set_state(gen_state)
        grads.append(cls_seg_train.cls_seg_loss_and_grads(cfg, state, batches[0])[2])
        discard_batch_stats(model)
    check(all(torch.equal(a, b) for a, b in zip(*grads)),
          f"{label}: the same step from one state twice gives bit-identical gradients")
    del grads
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(xyz, feat), reps=5)
        fwd_b1_ms = time_ms(forward_b1, reps=10)
        _, device = profile_device_events(lambda: model(xyz, feat))
        fwd_prof = summarize_device_events(device)
    _, device = profile_device_events(
        lambda: cls_seg_train.cls_seg_train_step(cfg, state, batches[1]))
    step_prof = summarize_device_events(device)
    step = statistics.median(step_ms[1:])  # the first step warms the backward
    log(f"{label}: forward {fwd_ms:.2f} ms at B={CLS_SEG_BATCH}, {fwd_b1_ms:.2f} ms at B=1; train "
        f"step {step:.2f} ms ({step_prof['device_launches']} device launches, idle "
        f"{step_prof['idle_share']:.3f}); peak {peak / 2**30:.2f} GiB")
    return {
        "config": f"{task}, {n_points} points, batch {CLS_SEG_BATCH}, float32 (TF32 off), "
                  "seeded random weights, procedural data",
        "launches_forward": fwd_launches, "launches_train_step": step_launches,
        "losses": losses.tolist(), "forward_ms_b32": fwd_ms, "forward_ms_b1": fwd_b1_ms,
        "forward_profile": fwd_prof, "train_step_ms": step, "train_step_ms_runs": step_ms,
        "train_clouds_per_s": CLS_SEG_BATCH / step * 1e3, "train_step_profile": step_prof,
        "peak_memory_bytes": peak,
    }


def cls_seg_cli_drive(work: str) -> dict:
    """train_net_torch.py --model cls and --model semseg for one epoch of two
    batches of 32 on procedural data, at the recipes' point counts; the
    pickle loads into the port."""
    out = {}
    for task, n_points in (("cls", 1024), ("semseg", 4096)):
        log_dir = str(Path(work, task))
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = train_net_torch.main(["--do_train", "--model", task, "--dataset", "synthetic",
                                       "--num_points", str(n_points), "--batch_size", "32",
                                       "--synthetic_batches", "2", "--num_epochs", "1",
                                       "--log_dir", log_dir])
        line = text.getvalue().strip().splitlines()[-1]
        log(f"train_net_torch.py --model {task}: {line}")
        with open(Path(log_dir, "cls_seg_state.pkl"), "rb") as f:
            tree = pickle.load(f)
        load_flax_variables(cls_seg_model(task, cls_seg_models.CLS_SSG if task == "cls"
                                          else cls_seg_models.SEM_SSG), tree)
        check(rc == 0 and line.startswith("epoch 0: loss="),
              f"train_net_torch.py --model {task} exits 0; its pickle loads into the port")
        out[task] = {"seconds": time.perf_counter() - t0, "epoch_line": line}
    return out


def cls_seg_phase() -> dict:
    t0 = time.perf_counter()
    out = {"cases": cls_seg_kernel_cases()}
    out["small_card_vs_cpu"] = cls_seg_small_card_vs_cpu()
    for label in CLS_SEG_CELLS:
        out[label] = cls_seg_drive(label)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        out["cli"] = cls_seg_cli_drive(work)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 12: the KITTI-profile world on the card, and PWCLO-Net trained and
# tested on it through train_net_torch.py dataset=synthetic_world
# ---------------------------------------------------------------------------

# full frames of kitti_preset()'s drive held card against CPU (its traffic in)
WORLD_CHECK_FRAMES = (0, 199, 398, 597, 796, 994)
WORLD_PROFILE_FRAMES = 50  # the cast's device time and idle share, profiled
# the train and test drive, cut in depth only: two train worlds and one eval
# world (the train_net.py recipe: 240 frames a world, as many worlds as asked)
# of 48 frames, one epoch; one held-out test world of 48 frames
WORLD_FRAMES = 48
WORLD_TRAIN = ["dataset=synthetic_world", "num_points=8192", f"synthetic_frames={WORLD_FRAMES}"]
FUSED_TOL = {"mlp_maxpool": dict(atol=3e-5, rtol=1e-4),
             "attentive_aggregate": dict(atol=5e-5, rtol=1e-4)}


def in_float64(args: tuple) -> tuple:
    """A fused call's arguments in float64, its folded stacks included."""
    def cast(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, tuple):  # a folded stack (weights, biases)
            return tuple([t.double() for t in part] for part in a)
        return a
    return tuple(cast(a) for a in args)


def mlp_term_scale(x: torch.Tensor, wb) -> float:
    """The largest sum of magnitudes a layer of an MLP stack adds in one
    dot product (``|h|·|W| + |b|``, in float64): the scale at which float32
    rounds it."""
    h, scale = x.double(), 0.0
    for w, b in zip(*wb):
        scale = max(scale, (h.abs() @ w.double().abs() + b.double().abs()).max().item())
        h = torch.relu(h @ w.double() + b.double())
    return scale


def fused_call_case(kind: str, args: tuple) -> dict:
    """One recorded call of a fused kernel on its own inputs: its error
    against the plain version and both against the same function in float64,
    timed, with its bounds. ``held`` is true where the kernel is within phase
    2's tolerance of the plain version or of the float64 value: at the trained
    weights' scale (layer sums of up to ~900) the plain float32 version itself
    misses the float64 value by more than phase 2's atol."""
    kernel, plain = {"mlp_maxpool": (mlp_mod._mlp_maxpool_cuda, mlp_maxpool_plain),
                     "attentive_aggregate": (cv_mod._attentive_aggregate_cuda,
                                             attentive_aggregate_plain)}[kind]
    out, ref = kernel(*args), plain(*args)
    exact = plain(*in_float64(args))
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = FUSED_TOL[kind]
    diag = {"within_tolerance": bool(torch.allclose(out, ref, **tol)),
            "within_tolerance_of_float64": bool(torch.allclose(out.double(), exact, **tol)),
            "kernel_err_vs_float64": (out.double() - exact).abs().max().item(),
            "plain_err_vs_float64": (ref.double() - exact).abs().max().item()}
    diag["held"] = diag["within_tolerance"] or diag["within_tolerance_of_float64"]
    if kind == "mlp_maxpool":
        x, wb = args
        stacks, inputs, rows = [wb], (x,), x.shape[0] * x.shape[1] * x.shape[2]
        name = f"B={x.shape[0]} ({x.shape[1]},{x.shape[2]},{x.shape[3]})"
        diag["layer_sum_max"] = mlp_term_scale(x, wb)
    else:
        cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, center = args
        stacks = [wb for wb in (enc_wb, emb_wb, att_wb) if wb is not None]
        inputs, rows = (cxyz, gxyz, cfeat, gfeat), gxyz.shape[0] * gxyz.shape[1] * gxyz.shape[2]
        name = (f"{'self' if center else 'cross'} B={gxyz.shape[0]} ({gxyz.shape[1]},"
                f"{gxyz.shape[2]},{cfeat.shape[-1]},{gfeat.shape[-1]})")
    log(f"{kind} {name}: max {err:.3g} from plain; {diag}")
    macs = rows * sum(stack_macs(wb[0][0].shape[0], wb) for wb in stacks)
    nbytes = 4 * (sum(t.numel() for t in inputs) + out.numel()) + sum(
        stack_bytes(wb) for wb in stacks)
    bnd, by = bound_ms(nbytes, 6.0 * macs, TF32_FLOPS)
    return {"shape": name, "max_abs_err": err, "bound_ms": bnd, "bound_by": by, **diag,
            "bound_fp32_ms": bound_ms(nbytes, 2.0 * macs)[0],
            **kernel_times(lambda: kernel(*args), lambda: plain(*args), None, 50, 20)}


def summed(rows: list) -> dict:
    """A kernel's calls of one step or forward, summed: each timed shape
    times its launches (no library time where a shape has none)."""
    library = all(r["library_ms"] is not None for r in rows)
    out = weighted_sums(rows, ("ms", "call_ms", "plain_ms", "bound_ms")
                        + (("library_ms",) if library else ()))
    by = {r["bound_by"] for r in rows}
    return {"library_ms": None, **out, "shapes": len(rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bound_by": by.pop() if len(by) == 1 else "operations"}


def world_cast_phase() -> dict:
    """``kitti_preset()`` on the card: full frames card against CPU under the
    borderline-ray rule, the moving box's hits, and the whole 995-frame
    generation timed, its cast apart from its host loop."""
    cfg = kitti_preset()
    dirs = lidar_directions(cfg.num_beams, cfg.num_cols, cfg.fov_up_deg, cfg.fov_down_deg)
    poses = make_trajectory(cfg.trajectory, cfg.n_frames, cfg.speed, cfg.yaw_rate_deg)
    t0 = time.perf_counter()
    rects, dyn = kitti_world(poses, cfg.seed)
    world_s = time.perf_counter() - t0
    frames = list(WORLD_CHECK_FRAMES)
    dyn_rects = [r for t in frames for d in dyn for r in d.rects_at(t)]
    per = len(dyn_rects) // len(frames)
    extra = [np.arange(len(rects) + i * per, len(rects) + (i + 1) * per)
             for i in range(len(frames))]
    casters = {dev: FrameRaycaster(rects + dyn_rects, n_static=len(rects), device=dev)
               for dev in ("cuda", "cpu")}
    casts = {dev: c.cast_all(poses[frames], dirs, extra) for dev, c in casters.items()}
    diff = cast_differences(casters["cpu"].soa, poses[frames], dirs, *casts["cuda"],
                            *casts["cpu"])
    traffic = int((casts["cuda"][1] >= len(rects)).sum())
    log(f"cast card vs CPU over {len(frames)} frames of {len(dirs)} rays: {diff}; "
        f"{traffic} rays on the traffic")
    check(diff["unexplained"] == 0 and traffic > 0,
          f"the card's casts are the CPU's but at borderline rays ({diff['differing']} of "
          f"{diff['rays']} differ, none unexplained; {len(dyn)} moving boxes hit)")

    # the moving box of tests/test_synthetic.py, on the card at 64 x 720
    ground = [Rect(np.array([-100.0, -100.0, -1.7]), np.array([200.0, 0, 0]),
                   np.array([0, 200.0, 0]))]
    box = DynamicBox(center=np.array([10.0, 0.0, -0.9]), size=np.array([3.0, 2.0, 1.6]),
                     velocity=np.array([0.0, 0.5, 0.0]))
    ranges, idx = FrameRaycaster(ground + [r for t in range(5) for r in box.rects_at(t)],
                                 n_static=1).cast_all(
        make_trajectory("straight", 5, speed=0.0), dirs,
        [np.arange(1 + t * 5, 1 + (t + 1) * 5) for t in range(5)])
    ys = [(dirs[h] * ranges[t][h, None])[:, 1].mean()
          for t, h in enumerate(np.isfinite(ranges) & (idx >= 1))]
    dy = np.diff(ys)
    check(bool((dy > 0.3).all() and (dy < 0.7).all()),
          f"the moving box's hits follow it +0.5 m a frame ({np.round(dy, 3).tolist()})")

    # the whole preset, as train_net_torch.py makes its worlds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans, times, gt = generate_sequence_with_times(cfg)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cast_rigid_sweeps(rects, dyn, poses, dirs)
    cast_s = time.perf_counter() - t0
    n_valid = (np.linalg.norm(scans, axis=-1) > 1e-3).sum(1)
    check(scans.shape == (cfg.n_frames, 8192, 3) and bool(np.isfinite(scans).all())
          and n_valid.min() > 6000 and np.array_equal(gt, poses),
          f"{cfg.n_frames} frames of 8192 points, finite, at least {n_valid.min()} valid a frame")
    sub = slice(0, WORLD_PROFILE_FRAMES)
    _, device = profile_device_events(lambda: cast_rigid_sweeps(rects, dyn, poses[sub], dirs))
    prof = summarize_device_events(device)
    host_s = gen_s - cast_s - world_s
    device_a_frame = prof["device_ms"] / WORLD_PROFILE_FRAMES
    log(f"kitti_preset(): {cfg.n_frames} frames in {gen_s:.2f} s: cast {cast_s:.2f} s "
        f"({1e3 * cast_s / cfg.n_frames:.2f} ms a frame; device {device_a_frame:.3f} ms a "
        f"frame, idle {prof['idle_share']:.3f}), host loop {host_s:.2f} s "
        f"({1e3 * host_s / cfg.n_frames:.2f} ms a frame), world {world_s:.2f} s")
    return {"frames": cfg.n_frames, "rays_a_frame": len(dirs), "rects": len(rects),
            "moving_boxes": len(dyn), "card_vs_cpu": {"frames": frames, **diff,
                                                     "rays_on_traffic": traffic},
            "moving_box_dy": dy.tolist(), "generate_s": gen_s, "cast_s": cast_s,
            "host_loop_s": host_s, "world_s": world_s,
            "cast_ms_a_frame": 1e3 * cast_s / cfg.n_frames,
            "host_loop_ms_a_frame": 1e3 * host_s / cfg.n_frames,
            "cast_profile": {**prof, "frames": WORLD_PROFILE_FRAMES,
                             "device_ms_a_frame": device_a_frame},
            "valid_points_min": int(n_valid.min())}


def world_train_phase(log_dir: str) -> dict:
    """``train_net_torch.py do_train=true dataset=synthetic_world`` at full
    width (8192 points, batch 8), the counters zeroed before and read after;
    then one step of the trained state recorded, every point-kernel call
    held to its plain version."""
    args = [*WORLD_TRAIN, "do_train=true", "batch_size=8", "num_epochs=1",
            "train_sequences=0,1", "eval_sequences=0", f"log_dir={log_dir}"]
    cfg = train_net_torch.parse_cli(train_net_torch.Config, args)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_net_torch.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    steps, evals = 2 * (WORLD_FRAMES - 1) // 8, (WORLD_FRAMES - 1) // 8
    want = {k: steps * v + evals * LAUNCHES_PER_FORWARD[False][k]
            for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
    check(rc == 0 and counts == want,
          f"train_net_torch.py dataset=synthetic_world: {steps} steps and {evals} eval "
          f"forwards launched {counts}")
    record = json.loads(Path(log_dir, "history.jsonl").read_text().splitlines()[-1])
    check(math.isfinite(record["train_loss"]) and math.isfinite(record["eval_loss"]),
          f"finite losses ({text.getvalue().strip().splitlines()[-1]})")
    trained = train_net_torch._trainer(cfg)
    init = {k: v.clone() for k, v in trained.state.trainable().items()}
    trained.load_checkpoint()
    after = trained.state.trainable()
    changed = sum(not torch.equal(init[k], v) for k, v in after.items())
    check(changed > 0 and all(bool(torch.isfinite(v).all()) for v in after.values()),
          f"the trained parameters are finite and moved ({changed} of {len(after)} leaves)")

    batch = next(iter(train_net_torch.make_batch_fns(cfg)[0]()))
    state = trained.state

    def step():
        tstate.loss_and_grads(trained.config.train, state, batch)
        discard_batch_stats(state.model)

    _cuda.reset_launch_counts()
    calls = recorded_calls(each_call(point_targets()), step)
    step_counts = _cuda.launch_counts()
    check(step_counts == LAUNCHES_PER_TRAIN_STEP,
          f"one recorded train step launched {step_counts}")
    valid = (batch["xyz1"] ** 2).sum(-1) > 1e-3
    cases = recorded_kernel_cases(calls, "synthetic_world train step")
    return {"seconds": seconds, "steps": steps, "eval_forwards": evals, "launches": counts,
            "launches_a_step": step_counts, "train_loss": record["train_loss"],
            "eval_loss": record["eval_loss"], "changed_leaves": changed,
            "leaves": len(after), "padding_rows_in_batch": int((~valid).sum()),
            "cases": cases}


def world_test_phase(log_dir: str) -> dict:
    """``do_test=true dataset=synthetic_world fused_eval=true`` on one
    held-out world from the train drive's checkpoint: exact launches, the
    reference's result files; then one fused forward recorded, every fused
    call held as :func:`fused_call_case` says and every point kernel call
    equal to its own."""
    args = [*WORLD_TRAIN, "do_test=true", "fused_eval=true", "test_sequences=0",
            f"log_dir={log_dir}"]
    cfg = train_net_torch.parse_cli(train_net_torch.Config, args)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_net_torch.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    want = {k: (WORLD_FRAMES - 1) * v for k, v in LAUNCHES_PER_FORWARD[True].items()}
    check(rc == 0 and counts == want,
          f"do_test fused over {WORLD_FRAMES} frames launched {counts}")
    test_dir = Path(log_dir, "test")
    est, gt = read_poses_txt(str(test_dir / "00.poses.txt")), read_poses_txt(
        str(test_dir / "00_gt.poses.txt"))
    check(est.shape == gt.shape == (WORLD_FRAMES, 4, 4) and is_se3(est)
          and (test_dir / "metrics.yaml").exists() and (test_dir / "00_eval").is_dir(),
          f"the test mode wrote the reference's result files "
          f"({text.getvalue().strip().splitlines()[-1]})")

    trainer = train_net_torch._trainer(cfg, fused_eval=True)
    trainer.load_checkpoint()
    odo = PWCLONetOdometry(trainer.state.state_dict(), DeepOdometryConfig(
        model=trainer.config.train.model, num_points=cfg.num_points))
    seq = train_net_torch.make_test_sequence(cfg, 0)
    x1, x2 = (torch.from_numpy(odo._prepare(seq.scan(i)))[None].cuda() for i in (1, 0))

    def forward():
        with torch.inference_mode():
            odo.model(x1, x2)

    forward()  # folds and lays out the weights once, as a running odometry has
    _cuda.reset_launch_counts()
    calls = recorded_calls(each_call({**point_targets(), **fused_targets(cv_mod, mlp_mod)}),
                           forward)
    fwd_counts = _cuda.launch_counts()
    check(fwd_counts == LAUNCHES_PER_FORWARD[True],
          f"one recorded fused forward launched {fwd_counts}")
    with torch.inference_mode():
        cases = recorded_kernel_cases(calls, "synthetic_world fused forward")
    outside = {}
    for kind in ("mlp_maxpool", "attentive_aggregate"):
        out_of = outside[kind] = [
            (c["shape"], c["kernel_err_vs_float64"], c["plain_err_vs_float64"])
            for c in cases[kind] if not c["within_tolerance"]]
        check(all(c["held"] for c in cases[kind]),
              f"synthetic_world fused forward: every {kind} call within {FUSED_TOL[kind]} of its "
              f"plain version or of the float64 value (outside the tolerance of the plain "
              f"version, with the kernel's and the plain version's errors against float64: "
              f"{out_of})")
    return {"seconds": seconds, "launches": counts, "launches_a_forward": fwd_counts,
            "result_line": text.getvalue().strip().splitlines()[-1],
            "fused_calls_outside_phase2_tolerance": outside, "cases": cases}


def world_kernel_lines(world: dict) -> list:
    """One line a kernel of the six for phase 12's path: the train drive's
    launches and its recorded step's calls summed for FPS, kNN, the gather
    and the scatter-add; the test drive's and its recorded fused forward's
    for the two fused kernels; each with the other drive's launches."""
    lines = []
    for name in ("fps", "knn", "gather", "scatter_add", "mlp_maxpool", "attentive_aggregate"):
        source, replaces = KERNELS[name]
        part = "test" if name in ("mlp_maxpool", "attentive_aggregate") else "train"
        row = world[part]["summed"][name]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": world[part]["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "synthetic_world": {
                "launches_train_drive": world["train"]["launches"][name],
                "launches_a_train_step": world["train"]["launches_a_step"][name],
                "launches_test_drive": world["test"]["launches"][name],
                "launches_a_test_forward": world["test"]["launches_a_forward"][name],
                "train_step_summed": world["train"]["summed"].get(name),
                "test_forward_summed": world["test"]["summed"].get(name)},
        })
    return lines


def world_phase() -> dict:
    t0 = time.perf_counter()
    out = {"cast": world_cast_phase()}
    with tempfile.TemporaryDirectory() as log_dir:
        out["train"] = world_train_phase(log_dir)
        out["test"] = world_test_phase(log_dir)
    for part in ("train", "test"):
        out[part]["summed"] = {k: summed(rows) for k, rows in out[part]["cases"].items()}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 13: batched multi-sequence ICP odometry (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------

# config/kitti_batched.yaml: the 11 KITTI sequences at 8192 points in one
# batched step a frame; here 11 KITTI-profile worlds of one chunk (32 frames)
# each, cast on the card. The ICPConfig run_slam_torch.py's batched path
# builds, projective and voxel (the candidate cache off, as the batched mode
# forces it)
BATCHED_SEQUENCES = 11
BATCHED_FRAMES = 32  # one chunk of run_batched
BATCHED_CONFIGS = {
    "projective": icp.ICPConfig(num_points=8192),
    "voxel": icp.ICPConfig(num_points=8192, association="voxel"),
}
BATCHED_CARRY_FRAMES = 8  # the step from one state held for every sequence: frame 8's
BATCHED_STEP_ATOL_M = 1e-5  # one step from one state, batched against process_frame
# the frames whose batched step is held against process_frame from the same
# state. Projective: every frame, since projective ICP without the BEV prior
# loses track on most of these worlds, the reference as much
# (tests/icp_world_ate.py), and there a whole chain says little (on an H100,
# world 8's batched chain parts from the single path's by 128.6 m, against
# 3 x 24.6 m of the single path's own one-ulp movement). A step is held where
# the single step reproduces itself: its Gauss-Newton loop converged before
# the cap (a loop cut at the cap is not stable to rounding: on an H100, 5 of
# 220 such steps that no nudge of +-1 or +-2 ulp moves part by up to
# 0.092 m) and a one-ulp nudge of its scan moves it by less than the bar.
# Voxel: frame 8, beside its whole chains
BATCHED_STEP_FRAMES = {"projective": tuple(range(BATCHED_FRAMES)),
                       "voxel": (BATCHED_CARRY_FRAMES,)}
BATCHED_CHAIN_MODES = ("voxel",)  # chains held at max(1e-3, 3 x the single path's sens)
BATCHED_EQUAL_ATOL_M = 1e-5  # tests/test_icp_odometry.py:424-426
BATCHED_PROFILED_STEPS = 4
BATCHED_T_REL_SEGMENTS = (5.0, 10.0, 20.0)  # m: KITTI's 100-800 m outrun 32 frames


def batched_worlds() -> tuple:
    """The 11 worlds: ``kitti_preset(32, seed=s, num_points=8192)``, cast on
    the card; ``(scans (S, T, N, 3), ground truth (S, T, 4, 4))``."""
    out = [generate_sequence(kitti_preset(BATCHED_FRAMES, seed=s, num_points=8192))
           for s in range(BATCHED_SEQUENCES)]
    return (np.stack([s for s, _ in out]).astype(np.float32),
            np.stack([g for _, g in out]))


def nudge_ulp(scans: np.ndarray, direction: float) -> np.ndarray:
    """Every non-zero coordinate moved by one float32 ulp toward ``direction``."""
    return np.where(scans != 0, np.nextafter(scans, np.float32(direction)), 0.0).astype(np.float32)


def sequence_state(states: icp.OdometryState, s: int) -> icp.OdometryState:
    return icp.state_from_leaves(x[s].clone() for x in icp.state_leaves(states))


def batched_steps(cfg, scans: np.ndarray, frames) -> dict:
    """The batched chain over ``scans (S, T, N, 3)``, stepped frame by frame.
    At each frame of ``frames``, each sequence's batched step against
    ``process_frame`` from its own slice of the same state (``step_gap_m``),
    that single step against the single step on the frame's scan moved by
    one float32 ulp up (``step_sens_m``: the single path's own sensitivity
    from that state; None where it is not run), whether the single step's
    Gauss-Newton loop converged before its cap (``step_converged``) and
    whether the two steps ran the same iterations. Translation gaps,
    (frames, S)."""
    def frame_major(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2, 3))).cuda()

    exact, moved = frame_major(scans), frame_major(nudge_ulp(scans, np.inf))
    st = icp.init_states(cfg, scans.shape[0], device="cuda")
    out = {"step_frames": list(frames), "step_gap_m": [], "step_sens_m": [],
           "step_converged": [], "step_iterations_equal": []}
    for f in range(max(frames) + 1):
        batched_stats = icp.StepStats()
        nxt, batched = icp.process_frame_batched(cfg, st, exact[f], batched_stats)
        if f in frames:
            gap, sens, converged, same = [], [], [], []
            for q in range(scans.shape[0]):
                one, stats = sequence_state(st, q), icp.StepStats()
                single = icp.process_frame(cfg, one, exact[f, q], stats)[1].pose[:3, 3]
                gap.append((batched.pose[q, :3, 3] - single).abs().max())
                converged.append(stats.iterations < cfg.max_num_alignments)
                if converged[-1]:  # a step cut at the cap is not held: no nudge
                    sens.append((icp.process_frame(cfg, one, moved[f, q])[1].pose[:3, 3]
                                 - single).abs().max())
                else:
                    sens.append(gap[-1].new_tensor(math.nan))
                same.append(stats.iterations == batched_stats.sequence_iterations[q])
            out["step_gap_m"].append(torch.stack(gap).tolist())
            out["step_sens_m"].append([None if math.isnan(x) else x
                                       for x in torch.stack(sens).tolist()])
            out["step_converged"].append(converged)
            out["step_iterations_equal"].append(same)
        st = nxt
    return out


def serial_chains(cfg, scans: np.ndarray, sensitivity: bool) -> dict:
    """``ICPOdometry.process_sequence`` over each sequence (timed, alone on
    the card); with ``sensitivity``, also over its scans moved by one
    float32 ulp up and down: the single path's own sensitivity on that
    sequence (``sens``, m)."""
    chains, reads, iters, seconds = [], [], [], 0.0
    for s in range(scans.shape[0]):
        odo = icp.ICPOdometry(cfg, device="cuda")
        odo.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains.append(odo.process_sequence(scans[s]))
        seconds += time.perf_counter() - t0
        reads.append(list(odo.host_reads))
        iters.append(list(odo.iterations))
    chains = np.stack(chains)
    sens = None
    if sensitivity:
        sens = np.zeros(scans.shape[0])
        odo = icp.ICPOdometry(cfg, device="cuda")
        for direction in (np.inf, -np.inf):
            moved = nudge_ulp(scans, direction)
            for s in range(scans.shape[0]):
                odo.init()
                gap = np.abs(odo.process_sequence(moved[s])[:, :3, 3] - chains[s, :, :3, 3]).max()
                sens[s] = max(sens[s], gap)
        sens = sens.tolist()
    return {"chains": chains, "sens": sens, "host_reads": reads, "iterations": iters,
            "seconds": seconds}


def batched_profile(cfg, scans: np.ndarray) -> dict:
    """Launches, device ms and idle share of ``BATCHED_PROFILED_STEPS``
    batched steps from the state after ``BATCHED_CARRY_FRAMES`` frames, and
    the host reads and iterations of those steps."""
    odo = icp.BatchedICPOdometry(cfg, device="cuda")
    odo.init(scans.shape[0])
    odo.process_chunk(scans[:, :BATCHED_CARRY_FRAMES])
    st0 = odo.states
    end = BATCHED_CARRY_FRAMES + BATCHED_PROFILED_STEPS
    frames = torch.from_numpy(np.ascontiguousarray(
        scans[:, BATCHED_CARRY_FRAMES:end].transpose(1, 0, 2, 3))).cuda()
    stats = []

    def steps():
        stats.clear()
        st = st0
        for t in range(BATCHED_PROFILED_STEPS):
            stats.append(icp.StepStats())
            st, _ = icp.process_frame_batched(odo.config, st, frames[t], stats[-1])

    _, device = profile_device_events(steps)
    prof = summarize_device_events(device)
    n = BATCHED_PROFILED_STEPS
    return {
        "sequences": scans.shape[0],
        "launches_per_step": prof["device_launches"] / n,
        "device_ms_per_step": prof["device_ms"] / n,
        "idle_share": prof["idle_share"],
        "host_reads_per_step": [st.host_reads for st in stats],
        "gn_iterations_per_step": [st.iterations for st in stats],
        "sequence_iterations": [st.sequence_iterations for st in stats],
        "top_kernels": prof["top_kernels"][:6],
    }


def batched_equal_pair(cfg, scans: np.ndarray) -> dict:
    odo = icp.BatchedICPOdometry(cfg, device="cuda")
    odo.init(2)
    poses = odo.process_chunk(np.stack([scans[0]] * 2))
    gap = float(np.abs(poses[0, :, :3, 3] - poses[1, :, :3, 3]).max())
    return {"equal_pair_gap_m": gap, "equal_pair_bit_equal": bool(np.array_equal(poses[0], poses[1]))}


def batched_mode(mode: str, scans: np.ndarray, gt: np.ndarray) -> dict:
    cfg = BATCHED_CONFIGS[mode]
    s, t = scans.shape[:2]
    odo = icp.BatchedICPOdometry(cfg, device="cuda")
    odo.init(s)
    odo.process_chunk(scans[:, :2])  # warm
    odo.init(s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    poses = odo.process_chunk(scans)  # one upload, 32 batched steps, one fetch
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    out = {
        "config": repr(odo.config),
        "ms_per_batched_step": 1e3 * seconds / t,
        "frames_per_s_summed": s * t / seconds,
        "peak_memory_bytes": peak,
        "host_reads_per_step": list(odo.host_reads),
        "gn_iterations_per_step": [max(it) for it in odo.iterations],
    }
    serial = serial_chains(odo.config, scans, sensitivity=mode in BATCHED_CHAIN_MODES)
    out["serial_frames_per_s"] = s * t / serial["seconds"]
    out["serial_max_host_reads_per_frame"] = [max(r[f] for r in serial["host_reads"])
                                              for f in range(t)]
    out["iterations_equal_share"] = float(np.mean([
        odo.iterations[f][q] == serial["iterations"][q][f] for f in range(t) for q in range(s)]))
    sens = serial["sens"]
    gaps = [float(np.abs(poses[q, :, :3, 3] - serial["chains"][q, :, :3, 3]).max())
            for q in range(s)]
    rot_gaps = [float(np.abs(poses[q, :, :3, :3] - serial["chains"][q, :, :3, :3]).max())
                for q in range(s)]
    bars = [max(1e-3, 3.0 * x) for x in sens] if sens else None
    out.update({"chain_gap_m": gaps, "chain_rot_gap": rot_gaps, "chain_bar": bars,
                "single_path_sens_m": sens,
                "chain_bit_equal": [bool(np.array_equal(poses[q], serial["chains"][q]))
                                    for q in range(s)]})
    out["ate_m_per_frame"], out["t_rel_pct"] = [], []
    for q in range(s):
        md = odo_metrics.metrics_dict(poses[q], gt[q], segments=BATCHED_T_REL_SEGMENTS)
        out["ate_m_per_frame"].append(md["ATE"])
        out["t_rel_pct"].append(md["tr_err"])
    out.update(batched_steps(odo.config, scans, BATCHED_STEP_FRAMES[mode]))
    step_gap = np.array(out["step_gap_m"])  # (frames, S)
    step_sens = np.array(out["step_sens_m"], dtype=float)  # None -> nan: not held
    carry = np.array(out["step_gap_m"][out["step_frames"].index(BATCHED_CARRY_FRAMES)])
    # where the single step reproduces itself: its loop converged before the
    # cap and a one-ulp nudge of its scan moves it by less than the bar
    stable = (step_sens < BATCHED_STEP_ATOL_M) & np.array(out["step_converged"])
    same_iterations = np.array(out["step_iterations_equal"])
    out.update({"carry_step_gap_max_m": float(carry.max()),
                "steps_held": int(stable.sum()), "steps": int(stable.size),
                "steps_converged": int(np.sum(out["step_converged"])),
                "held_steps_iterations_equal": int(same_iterations[stable].sum()),
                "held_step_gap_max_m": float(step_gap[stable].max(initial=0.0)),
                "free_step_gap_max_m": float(step_gap[~stable].max(initial=0.0))})
    out.update(batched_equal_pair(cfg, scans))
    out["profile_s1"] = batched_profile(cfg, scans[:1])
    out["profile_s11"] = batched_profile(cfg, scans)
    p1, p11 = out["profile_s1"], out["profile_s11"]
    log(f"batched ICP {mode}: {out['ms_per_batched_step']:.2f} ms a batched step of {s}, "
        f"{out['frames_per_s_summed']:.1f} frames/s summed (serial ICPOdometry "
        f"{out['serial_frames_per_s']:.1f}); a step at S=1 / S={s}: "
        f"{p1['launches_per_step']:.0f} / {p11['launches_per_step']:.0f} launches, "
        f"{p1['device_ms_per_step']:.3f} / {p11['device_ms_per_step']:.3f} device ms, "
        f"host reads {p1['host_reads_per_step']} / {p11['host_reads_per_step']}; idle "
        f"{p11['idle_share']:.3f}; peak {peak / 2**20:.0f} MiB")
    log(f"batched ICP {mode}: one step from one state at frame {BATCHED_CARRY_FRAMES} "
        f"{out['carry_step_gap_max_m']:.3g} m; over frames {out['step_frames'][0]}-"
        f"{out['step_frames'][-1]} the single step converged before the cap on "
        f"{out['steps_converged']} of {out['steps']} steps; {out['steps_held']} of those move "
        f"< {BATCHED_STEP_ATOL_M} m under a one-ulp nudge, within "
        f"{out['held_step_gap_max_m']:.3g} m, iterations equal on "
        f"{out['held_steps_iterations_equal']} (the others within "
        f"{out['free_step_gap_max_m']:.3g} m); chains {max(gaps):.3g} m, "
        f"{sum(out['chain_bit_equal'])} of {s} bit-equal; iterations equal on "
        f"{100 * out['iterations_equal_share']:.1f} % of sequence frames; equal pair "
        f"{out['equal_pair_gap_m']:.3g} m (bit-equal: {out['equal_pair_bit_equal']}); ATE "
        f"{min(out['ate_m_per_frame']):.4f}-{max(out['ate_m_per_frame']):.4f} m/frame")
    for q in range(s):
        same = np.mean([odo.iterations[f][q] == serial["iterations"][q][f] for f in range(t)])
        bar = (f", bar {bars[q]:.4g} (single-path sens {sens[q]:.4g} m)" if bars
               else " (not held)")
        log(f"  sequence {q}: chain gap {gaps[q]:.4g} m, rotation {rot_gaps[q]:.4g}{bar}, "
            f"steps held {int(stable[:, q].sum())} of {stable.shape[0]}, iterations equal on "
            f"{100 * same:.0f} % of frames, ATE {out['ate_m_per_frame'][q]:.4f} m/frame")
    check(out["carry_step_gap_max_m"] <= BATCHED_STEP_ATOL_M,
          f"batched ICP {mode}: one step from one state (frame {BATCHED_CARRY_FRAMES}) within "
          f"{BATCHED_STEP_ATOL_M} m of process_frame for each of the {s} sequences")
    check(out["held_step_gap_max_m"] <= BATCHED_STEP_ATOL_M
          and out["held_steps_iterations_equal"] == out["steps_held"],
          f"batched ICP {mode}: at frames {out['step_frames'][0]}-{out['step_frames'][-1]}, "
          f"each batched step within {BATCHED_STEP_ATOL_M} m of process_frame from the same "
          f"state, with its iterations, wherever that step converged before the cap and moves "
          f"< {BATCHED_STEP_ATOL_M} m under a one-ulp nudge ({out['steps_held']} of "
          f"{out['steps']})")
    if bars:
        check(all(gaps[q] <= bars[q] and rot_gaps[q] <= bars[q] for q in range(s)),
              f"batched ICP {mode}: the {t}-frame chain of each of the {s} sequences within "
              f"max(1e-3, 3 x the single path's one-ulp movement) of ICPOdometry")
    check(out["equal_pair_gap_m"] <= BATCHED_EQUAL_ATOL_M,
          f"batched ICP {mode}: two equal sequences within {BATCHED_EQUAL_ATOL_M} m")
    check(np.all(np.isfinite(poses)) and all(is_se3(poses[q]) for q in range(s)),
          f"batched ICP {mode}: finite SE(3) poses")
    return out


def batched_cli_drive(work: str) -> dict:
    """``run_slam_torch.py config=kitti_batched dataset=synthetic`` over the
    11 sequences of 32 frames at 8192 points, with a profiler trace."""
    log_dir, prof = str(Path(work, "run")), Path(work, "prof")
    argv = ["config=kitti_batched", "dataset=synthetic",
            "sequences=" + ",".join(str(s) for s in range(BATCHED_SEQUENCES)),
            f"synthetic_frames={BATCHED_FRAMES}", "num_points=8192", f"log_dir={log_dir}",
            f"profile_dir={prof}"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_slam_torch.main(argv)
    seconds = time.perf_counter() - t0
    poses = [read_poses_txt(str(Path(log_dir, f"synth{s:02d}.poses.txt")))
             for s in range(BATCHED_SEQUENCES)]
    traces = list(prof.glob("trace_*.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    kernel_events = len(re.findall(r'"cat"\s*:\s*"kernel"', text))
    check(rc == 0 and all(p.shape == (BATCHED_FRAMES, 4, 4) and np.all(np.isfinite(p))
                          for p in poses) and Path(log_dir, "metrics.yaml").exists(),
          "run_slam_torch.py config=kitti_batched: 11 pose files of 32 frames and metrics.yaml")
    check(kernel_events > 0, f"the profile_dir trace holds CUDA kernel events ({kernel_events})")
    return {"argv": argv, "seconds": seconds, "trace_bytes": len(text),
            "trace_kernel_events": kernel_events}


def batched_phase() -> dict:
    t0 = time.perf_counter()
    _cuda.reset_launch_counts()
    log(f"phase 13: casting {BATCHED_SEQUENCES} KITTI-profile worlds of {BATCHED_FRAMES} frames")
    scans, gt = batched_worlds()
    out = {"worlds_s": time.perf_counter() - t0}
    for mode in BATCHED_CONFIGS:
        out[mode] = batched_mode(mode, scans, gt)
    with tempfile.TemporaryDirectory() as work:
        out["cli"] = batched_cli_drive(work)
    counts = _cuda.launch_counts()
    check(all(v == 0 for v in counts.values()),
          "batched ICP launched none of the point-op kernels (plain PyTorch)")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 14: the parallel layer on torch.distributed (NCCL, world size 1)
# ---------------------------------------------------------------------------

# The card's machine has one H100, so the layer runs as one rank of a NCCL
# group on an in-memory store; every sharded function must then give its
# unsharded counterpart's result to the bit (an all-reduce over one rank is
# the identity). Its split of the work over ranks is held on the CPU with
# gloo at world sizes 1 and 2 (tests/test_torch_parallel.py).
PARALLEL_FRAMES = 8  # one chunk of the batched drive over phase 13's 11 worlds
PARALLEL_TRAIN_STEPS = 2
PARALLEL_TRAIN_BATCH = 8
# tests/test_parallel.py:28-68: loss rtol, the parameters' 99.9th percentile
# and largest differences after a step, against train_step on the whole batch
PARALLEL_LOSS_RTOL, PARALLEL_Q999, PARALLEL_MAX = 1e-4, 1e-4, 1e-2


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def parallel_icp_case(mesh, frames: np.ndarray) -> dict:
    """One 8192-point point-to-plane alignment from a KITTI-profile frame:
    the frame's returns as the target with seeded unit normals, the source
    that target moved by the inverse of a small SE(3)."""
    rng = np.random.default_rng(0)
    target = torch.from_numpy(frames[0, 0]).cuda()[None]
    normals = torch.from_numpy(rng.normal(size=target.shape[1:]).astype(np.float32)).cuda()[None]
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    true = se3.exp(torch.tensor([[0.05, -0.03, 0.02, 0.01, -0.02, 0.015]], device="cuda"))
    source = se3.transform(se3.inverse(true), target)
    mask = (torch.linalg.norm(target, dim=-1) > 0).float()
    ref = opt.solve_point_to_plane(source, target, normals, mask=mask)
    got = par.solve_point_to_plane_sharded(source, target, normals, mesh, mask=mask)
    return {"points": target.shape[1], "equal": _equal(ref, got),
            "true_pose_gap": float((got.pose - true).abs().max()),
            "iterations": int(got.num_iters[0])}


def parallel_map_case(mesh, frames: np.ndarray) -> dict:
    """The voxel table of ``ICPConfig()`` (2^14 rows of 64, octant cells of
    2 x 1.5 m) over a KITTI-profile frame's 8192 points, and the nearest
    neighbours of the next frame's 8192 within the 1.5 m reach."""
    cfg = icp.ICPConfig(num_points=8192)
    pts = torch.from_numpy(frames[0, 0]).cuda()
    nrm = torch.nn.functional.normalize(
        torch.from_numpy(np.random.default_rng(1).normal(size=pts.shape).astype(np.float32)),
        dim=-1).cuda()
    valid = (torch.linalg.norm(pts, dim=-1) > 0).float()
    query = torch.from_numpy(frames[0, 1]).cuda()
    cell = 2.0 * cfg.voxel_size
    kw = dict(table_size=cfg.voxel_table_size, bucket_cap=cfg.voxel_bucket_cap)
    ref = lm.build_voxel_table(pts, nrm, valid, cell, **kw)
    table = par.build_voxel_table_sharded(pts, nrm, valid, cell, mesh, **kw)
    nn_ref = lm.voxel_nn(ref, query, cfg.voxel_size, cfg.voxel_size, neighborhood=8)
    nn = par.voxel_nn_sharded(table, query, cfg.voxel_size, cfg.voxel_size, mesh,
                              neighborhood=8)
    return {"table_equal": _equal(ref, par.gather_voxel_table(table, mesh)),
            "nn_equal": _equal(nn_ref, nn), "queries": query.shape[0],
            "matched": int(nn[2].sum())}


def parallel_backend_case(mesh) -> dict:
    """``optimize_sharded`` on phase 8's 200-node circle (float32, the
    scatter-add kernel's type; 10 Gauss-Newton iterations), launches
    counted, against ``optimize``."""
    graph = circle_graph(capacity=(256, 512, 8)).to_device(torch.float32)
    cfg = backend.PGOConfig(max_iterations=10)  # tests/test_parallel.py's
    ref = backend.optimize(graph, cfg)
    stats = backend.PGOStats()
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    got = par.optimize_sharded(graph, mesh, cfg, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    expected = sum(2 + cg_launches(ran, cfg) for ran in stats.cg_iterations)
    check(launches["scatter_add"] == expected and sum(launches.values()) == expected,
          f"optimize_sharded launched the scatter-add kernel {launches['scatter_add']} times "
          f"({expected} from its {stats.gn_iterations} GN iterations) and no other kernel")
    return {"equal": torch.equal(ref.poses, got.poses), "launches": launches,
            "gn_iterations": stats.gn_iterations, "cg_iterations": stats.cg_iterations,
            "seconds": seconds}


def parallel_batched_case(mesh, scans: np.ndarray) -> dict:
    """``BatchedICPOdometry(mesh=...)`` over one chunk of ``PARALLEL_FRAMES``
    frames of the 11 worlds, projective, against ``mesh=None``."""
    cfg = BATCHED_CONFIGS["projective"]
    chunk = np.ascontiguousarray(scans[:, :PARALLEL_FRAMES])
    poses = {}
    for label, m in (("none", None), ("mesh", mesh)):
        odo = icp.BatchedICPOdometry(cfg, device="cuda", mesh=m)
        odo.init(chunk.shape[0])
        t0 = time.perf_counter()
        poses[label] = odo.process_chunk(chunk)
        poses[f"{label}_s"] = time.perf_counter() - t0
    return {"sequences": chunk.shape[0], "frames": PARALLEL_FRAMES,
            "equal": bool(np.array_equal(poses["none"], poses["mesh"])),
            "seconds_mesh_none": poses["none_s"], "seconds_mesh": poses["mesh_s"]}


def _timed_step(step) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def parallel_collective_costs(mesh, state, step, batch) -> dict:
    """What the data-parallel step's collectives cost: the BatchNorm calls of
    one step (each an all-gather of its moments, and an all-reduce of their
    gradient in the backward), and the host ms of one all-gather and one
    all-reduce of such a size on the mesh's group, each over 200 calls."""
    calls, moments = [], layers.batch_moments

    def counted(rows, shard):
        calls.append(rows.shape)
        return moments(rows, shard)

    layers.batch_moments = counted
    try:
        step(state, batch)
    finally:
        layers.batch_moments = moments
    ax = mesh_axis(mesh)
    x = torch.ones((2, 64), device="cuda")
    out = {"batchnorm_calls_a_step": len(calls)}
    for name, fn in (("all_gather", lambda: all_gather_rows(x, ax)),
                     ("all_reduce", lambda: dist.all_reduce(x, group=ax.group))):
        fn()
        out[f"{name}_ms"] = _timed_step(lambda: [fn() for _ in range(200)]) / 200
    return out


def parallel_train_case(mesh) -> dict:
    """``make_parallel_train_step`` at full width (the default
    ``PWCLONetConfig``, 8192 points, batch 8) for two steps from one seeded
    state, launches counted, against ``train_step`` from the same state."""
    cfg = tstate.TrainConfig(model=PWCLONetConfig())
    batch = random_batch(PARALLEL_TRAIN_BATCH, cfg.model.num_points, seed=1,
                        device=torch.device("cuda"))
    states = {k: tstate.create_train_state(cfg, seed=0, device="cuda") for k in ("single", "dp")}
    par.replicate_state(states["dp"], mesh)
    step = par.make_parallel_train_step(cfg, mesh)
    runs = {"dp": lambda: logs["dp"].append(step(states["dp"], batch)),
            "single": lambda: logs["single"].append(
                tstate.train_step(cfg, states["single"], batch))}
    logs, ms, launches = {"dp": [], "single": []}, {"dp": [], "single": []}, {}
    for label in ("dp", "single"):
        _cuda.reset_launch_counts()
        for _ in range(PARALLEL_TRAIN_STEPS):
            ms[label].append(_timed_step(runs[label]))
        launches[label] = _cuda.launch_counts()
    for label, counts in launches.items():
        want = {k: n * PARALLEL_TRAIN_STEPS for k, n in LAUNCHES_PER_TRAIN_STEP.items()}
        check(counts == want, f"{label} train steps launched {counts}, {PARALLEL_TRAIN_STEPS} x "
                              f"a step's {LAUNCHES_PER_TRAIN_STEP}")
    out = {"ms_a_step": ms, "launches": launches["dp"], "steps": []}
    for k in range(PARALLEL_TRAIN_STEPS):
        loss = [float(logs[label][k]["loss"]) for label in ("dp", "single")]
        out["steps"].append({"loss": loss})
    params = {label: torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
              for label, s in states.items()}
    diffs = (params["dp"] - params["single"]).abs()
    out["param_diff_q999"] = float(torch.quantile(diffs, 0.999))
    out["param_diff_max"] = float(diffs.max())
    out["bit_equal"] = bool(torch.equal(params["dp"], params["single"]) and all(
        torch.equal(a, b) for a, b in zip(states["dp"].model.buffers(),
                                          states["single"].model.buffers())))
    for k, s in enumerate(out["steps"]):
        check(abs(s["loss"][0] - s["loss"][1]) <= PARALLEL_LOSS_RTOL * abs(s["loss"][1]),
              f"data-parallel step {k + 1}: loss {s['loss'][0]:.9g} against train_step's "
              f"{s['loss'][1]:.9g} (rtol {PARALLEL_LOSS_RTOL})")
    check(out["param_diff_q999"] < PARALLEL_Q999 and out["param_diff_max"] < PARALLEL_MAX,
          f"parameters after {PARALLEL_TRAIN_STEPS} steps: 99.9th percentile of the differences "
          f"{out['param_diff_q999']:.3g} < {PARALLEL_Q999}, largest {out['param_diff_max']:.3g} "
          f"< {PARALLEL_MAX}")
    # then, on the states the check is done with: where the time goes
    out["collectives"] = parallel_collective_costs(mesh, states["dp"], step, batch)
    for label in ("dp", "single"):
        prof, events = profile_device_events(runs[label])
        summary = summarize_device_events(events)
        out[f"profile_{label}"] = {k: summary[k] for k in ("device_ms", "span_ms", "idle_share",
                                                           "device_launches", "top_kernels")}
        # the host's side: the ops that took the most of its own time
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
        out[f"profile_{label}"]["host_top_ops"] = [
            {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
            for e in ops]
    return out


def parallel_phase(scans: Optional[np.ndarray] = None) -> dict:
    """Phase 14 (runs last: it sets up, then destroys, a NCCL group of this
    process alone)."""
    t0 = time.perf_counter()
    if scans is None:
        log(f"phase 14: casting {BATCHED_SEQUENCES} KITTI-profile worlds of "
            f"{BATCHED_FRAMES} frames")
        scans, _ = batched_worlds()
    out = {"worlds_s": time.perf_counter() - t0}
    par.initialize(device="cuda")
    try:
        mesh = par.make_mesh(1, 1)
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and mesh.shape == (1, 1), "a NCCL group of one rank and its 1 x 1 mesh")
        try:
            par.make_mesh(2, 1)
            refused = False
        except ValueError as e:
            refused = "devices" in str(e)
        check(refused, "make_mesh(2, 1) raises: one rank, one device")
        out["icp"] = parallel_icp_case(mesh, scans)
        check(out["icp"]["equal"] and out["icp"]["true_pose_gap"] < 1e-4,
              f"solve_point_to_plane_sharded torch.equal to solve_point_to_plane at 8192 points "
              f"(true pose within {out['icp']['true_pose_gap']:.3g})")
        out["voxel_map"] = parallel_map_case(mesh, scans)
        check(out["voxel_map"]["table_equal"] and out["voxel_map"]["nn_equal"],
              f"build_voxel_table_sharded / voxel_nn_sharded torch.equal to the unsharded "
              f"functions ({out['voxel_map']['matched']} of 8192 queries matched)")
        out["backend"] = parallel_backend_case(mesh)
        check(out["backend"]["equal"], "optimize_sharded torch.equal to optimize, 200-node circle")
        out["batched"] = parallel_batched_case(mesh, scans)
        check(out["batched"]["equal"], "BatchedICPOdometry(mesh=make_mesh(1, 1)) equal to "
                                       "mesh=None over 11 worlds x 8 frames")
        out["train"] = parallel_train_case(mesh)
        log(f"train step ms, data-parallel {out['train']['ms_a_step']['dp']}, "
            f"single {out['train']['ms_a_step']['single']}")
        out["scaling"] = measure_scaling(ScalingConfig(num_points=8192, batch_per_device=8))
        print(json.dumps(out["scaling"][0]))
    finally:
        par.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


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
    parser.add_argument("--icp", action="store_true",
                        help="run phase 7 alone (classic ICP odometry, no kernel build); "
                             "prints its metrics and no ok line")
    parser.add_argument("--kernels", action="store_true",
                        help="stop after phase 2: build, each kernel against its plain version, "
                             "and the FPS, kNN and MLP launch variants; prints no ok line")
    parser.add_argument("--ct_icp", action="store_true",
                        help="run phase 9 alone (CT-ICP, elastic and rigid, no kernel build); "
                             "prints its metrics and no ok line")
    parser.add_argument("--posenet", action="store_true",
                        help="run phase 10 alone (PoseResNet odometry and training, no kernel "
                             "build); prints its metrics and no ok line")
    parser.add_argument("--cls_seg", action="store_true",
                        help="build, then phase 11 alone (the PointNet++ cls/semseg family at "
                             "full width); prints its metrics and no ok line")
    parser.add_argument("--world", action="store_true",
                        help="build, then phase 12 alone (the KITTI-profile world on the card, "
                             "PWCLO-Net trained and tested on it); prints its metrics and a "
                             "kernels line, no ok line")
    parser.add_argument("--batched", action="store_true",
                        help="run phase 13 alone (batched multi-sequence ICP and the profiler "
                             "hook, no kernel build); prints its metrics and no ok line")
    parser.add_argument("--parallel", action="store_true",
                        help="build, then phase 14 alone (the parallel layer: a NCCL group of "
                             "one rank, every sharded function against its unsharded "
                             "counterpart, the data-parallel train step at full width, the "
                             "scaling harness); prints its metrics and no ok line")
    parser.add_argument("--slam", action="store_true",
                        help="build, the SLAM kernel cases of phase 2, then phase 8 alone with a "
                             "checkpoint of seeded random weights; prints its metrics and no ok "
                             "line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products, as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    if args.icp:
        log("phase 7 alone: classic ICP odometry at full width, projective and voxel")
        print(card_line())
        print(json.dumps({"icp": icp_phase()}))
        return 0
    if args.batched:
        log("phase 13 alone: batched multi-sequence ICP odometry at full width")
        print(card_line())
        print(json.dumps({"batched_icp": batched_phase()}))
        return 0
    if args.ct_icp or args.posenet:
        print(card_line())
        if args.ct_icp:
            log("phase 9 alone: CT-ICP at full width, elastic and rigid")
            print(json.dumps({"ct_icp": ct_icp_phase()}))
        if args.posenet:
            log("phase 10 alone: PoseResNet odometry and training at full width")
            print(json.dumps({"posenet": posenet_phase()}))
        return 0

    log("phase 1: build the kernels")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    log(f"built {lib_path.name} in {build_s:.1f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    if args.cls_seg:
        log("phase 11 alone: the PointNet++ cls/semseg family at full width")
        cls_seg = cls_seg_phase()
        print(card_line())
        print(json.dumps({"cls_seg": cls_seg}))
        return 0
    if args.parallel:
        log("phase 14 alone: the parallel layer on torch.distributed, NCCL, world size 1")
        parallel = parallel_phase()
        print(card_line())
        print(json.dumps({"parallel": parallel}))
        return 0
    if args.world:
        log("phase 12 alone: the KITTI-profile world, PWCLO-Net trained and tested on it")
        world = world_phase()
        print(card_line())
        print(json.dumps({"world": world}))
        print(json.dumps({"kernels": world_kernel_lines(world)}))
        return 0

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

    if args.slam:
        log("phase 2, SLAM cases: the masked kNN, the refine's gather, the back end's scatter-add")
        submap = loop_closure_submap(scans, _gt)
        cases = {"knn_masked": masked_knn_cases(submap), "gather": [refine_gather_case(submap)],
                 "scatter_add": backend_scatter_cases()}
        with tempfile.TemporaryDirectory() as log_dir:
            PWCLONetTrainer(TrainerConfig(
                train=tstate.TrainConfig(model=PWCLONetConfig(fused_eval=True)),
                log_dir=log_dir)).save_checkpoint("seeded")
            slam = slam_phase(log_dir)
        print(card_line())
        print(json.dumps({"cases": cases}))
        print(json.dumps({"slam": slam}))
        return 0

    log("phase 2: kernels against their plain versions")
    cases, variants = kernel_phase(scan0, scan1, frames)
    submap = loop_closure_submap(scans, _gt)
    cases["knn_masked"] = masked_knn_cases(submap)
    cases["gather"].append(refine_gather_case(submap))
    cases["scatter_add"] += backend_scatter_cases()
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
    train_dir = tempfile.TemporaryDirectory()  # its checkpoint drives phase 8
    train = train_path_phase(scans, train_dir.name)
    learning = learning_phase()

    log("phase 6: times")
    train_times = train_timing_phase(train, show_table=args.profile)
    del train["trainer"], train["batches"]
    times = timing_phase(odos, scans)
    profiles = {}
    if args.profile:
        profiles = {label: profile_forward(label, odo, scans) for label, odo in odos.items()}

    log("phase 7: classic ICP odometry at full width, projective and voxel")
    icp_metrics = icp_phase()

    log("phase 8: SLAM, loop closure and the pose-graph back end")
    slam = slam_phase(train_dir.name)
    train_dir.cleanup()

    log("phase 9: CT-ICP at full width, elastic and rigid")
    ct_metrics = ct_icp_phase()

    log("phase 10: PoseResNet odometry and training at full width")
    pn_metrics = posenet_phase()

    log("phase 11: the PointNet++ cls/semseg family at full width")
    cls_seg = cls_seg_phase()
    for name, rows in cls_seg["cases"].items():
        cases[name] += rows

    log("phase 12: the KITTI-profile world on the card, PWCLO-Net trained and tested on it")
    world = world_phase()
    world_lines = {k["name"]: k for k in world_kernel_lines(world)}

    log("phase 13: batched multi-sequence ICP odometry at full width, projective and voxel")
    batched = batched_phase()

    log("phase 14: the parallel layer on torch.distributed, NCCL, world size 1")
    parallel = parallel_phase()

    kernels = []
    slam_icp = slam["slam-icp-loop"]["launches"]
    slam_deep = slam["slam-pwclonet-loop"]["launches"]
    for name, (source, replaces) in KERNELS.items():
        head = cases[name][0]
        kernel = "knn" if name == "knn_masked" else name
        # of the path that runs the kernel: the fused eval drive; the
        # training drive for the gather's backward; slam-icp-loop, whose kNN
        # launches are all masked, for the masked kNN
        path = {"scatter_add": train["launches"], "knn_masked": slam_icp}.get(
            name, main["fused"]["launches"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path[kernel],
            "launches_unfused_path": main["unfused"]["launches"][kernel],
            "launches_train_path": train["launches"][kernel],
            "launches_slam_icp_path": slam_icp[kernel],
            "launches_slam_pwclonet_path": slam_deep[kernel],
            "launches_cls_seg_paths": {
                label: {"forward": cls_seg[label]["launches_forward"][kernel],
                        "train_step": cls_seg[label]["launches_train_step"][kernel]}
                for label in CLS_SEG_CELLS},
            "synthetic_world": world_lines.get(name, {}).get("synthetic_world"),
            "launches_parallel_train_path": parallel["train"]["launches"][kernel],
            "launches_parallel_backend_path": parallel["backend"]["launches"][kernel],
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
        "profile": profiles, "icp": icp_metrics, "slam": slam, "ct_icp": ct_metrics,
        "posenet": pn_metrics, "cls_seg": {k: v for k, v in cls_seg.items() if k != "cases"},
        "world": world, "batched_icp": batched, "parallel": parallel,
        "total_s": time.perf_counter() - t_start,
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
    finite += [icp_metrics[mode][key] for mode in ICP_CONFIGS
               for key in ("process_next_frame_ms_median", "process_sequence_ms_per_frame",
                           "device_ms_per_frame", "ate_m_per_frame", "final_drift_m")]
    for label in ("slam-icp-loop", "slam-pwclonet-loop"):
        m = slam[label]
        finite += [m["ms_per_frame_median"], m["ms_per_submap_median"], m["host_reads_per_frame"],
                   m["profile"]["device_ms_per_frame"], m["final_error_m"]]
        finite += m["ms_per_optimization"]
    finite += [slam["drift"]["final_on_m"], slam["drift"]["final_off_m"]]
    finite += [ct_metrics[label][key] for label in CT_CONFIGS
               for key in ("process_next_frame_ms_median", "process_sequence_ms_per_frame",
                           "device_ms_per_frame")]
    finite += [ct_metrics["accuracy"][label]["final_drift_m"] for label in CT_CONFIGS]
    finite += [pn_metrics["train"]["times"][p]["train_step_ms"] for p in ("fp32", "tf32")]
    finite += [pn_metrics["odometry"][key] for key in ("forward_ms_b1",
                                                       "process_next_frame_ms_median")]
    finite += [cls_seg[label][key] for label in CLS_SEG_CELLS
               for key in ("forward_ms_b32", "forward_ms_b1", "train_step_ms")]
    finite += [world["cast"][key] for key in ("cast_ms_a_frame", "host_loop_ms_a_frame")]
    finite += [world[part][key] for part in ("train", "test") for key in ("seconds",)]
    finite += [world["train"][key] for key in ("train_loss", "eval_loss")]
    finite += [batched[mode][key] for mode in BATCHED_CONFIGS
               for key in ("ms_per_batched_step", "frames_per_s_summed", "serial_frames_per_s")]
    finite += [batched[mode][p][key] for mode in BATCHED_CONFIGS for p in ("profile_s1", "profile_s11")
               for key in ("device_ms_per_step", "idle_share")]
    finite += parallel["train"]["ms_a_step"]["dp"] + parallel["train"]["ms_a_step"]["single"]
    finite += [parallel["scaling"][0][key] for key in ("ms_per_step", "pairs_per_s")]
    check(all(math.isfinite(v) for v in finite), "every reported result is finite")
    check(len(kernels) == 7 and all(k["launches"] > 0 for k in kernels),
          "six kernels and the masked kNN, each launched on its main path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
