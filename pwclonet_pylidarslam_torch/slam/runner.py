"""SLAM runner: drive the pipeline over dataset sequences, evaluate, persist.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/runner.py``: a loop
over sequences with failure isolation (a crashing sequence is recorded and
the run continues), partial pose files every ``save_every_frames`` frames
with an incremental metric record, full-pipeline snapshots and resume,
GPS priors from a source's ``gps_poses()``, ``OdometryResults``
persistence (poses, ``metrics.yaml``, plots), and with ``gallery`` each
sequence's HTML gallery and player (``evaluation/gallery.py``,
``evaluation/player.py``; the gallery needs matplotlib: without it the
sequence is recorded as failed, as in the reference).
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Dict, Optional, Protocol, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation.gallery import write_run_gallery
from pwclonet_pylidarslam_torch.evaluation.player import write_run_player
from pwclonet_pylidarslam_torch.evaluation.results import OdometryResults, write_poses_txt
from pwclonet_pylidarslam_torch.slam.pipeline import SLAM, SLAMConfig


class SequenceSource(Protocol):
    """Anything that yields per-frame scans and optional GT poses; it may
    also expose ``gps_poses() -> Optional[(T, 4, 4)]``, per-frame absolute
    pose measurements with NaN where a frame has no fix."""

    def __len__(self) -> int: ...

    def scan(self, idx: int) -> np.ndarray: ...

    def ground_truth(self) -> Optional[np.ndarray]: ...


@dataclasses.dataclass
class SLAMRunnerConfig:
    """The reference's ``SLAMRunnerConfig``, whose comments give the reasons."""

    slam: SLAMConfig = dataclasses.field(default_factory=SLAMConfig)
    log_dir: str = "./slam_output"
    fail_on_error: bool = False
    max_frames: Optional[int] = None  # cap frames per sequence (debug)
    save_every_frames: int = 500  # partial trajectories survive crashes
    snapshot_every_frames: int = 0  # full-pipeline snapshot cadence (0 = off)
    resume: bool = False  # continue from a sequence's last snapshot
    use_gps: bool = False  # each source's gps_poses() as unary priors
    gps_information: Optional[np.ndarray] = None  # (6,6) or None = defaults
    gallery: bool = False  # each sequence's HTML gallery and player


class SLAMRunner:
    """Runs :class:`SLAM` over named sequences on ``device``, CUDA unless the
    caller asks for the CPU. ``odometry``: an odometry instance to use (and
    re-``init()``) for every sequence instead of the configured ICP."""

    def __init__(self, config: Optional[SLAMRunnerConfig] = None, odometry=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or SLAMRunnerConfig()
        self.device = resolve_device(device)
        self.results = OdometryResults(self.config.log_dir)
        self.failures: Dict[str, str] = {}
        self.pipelines: Dict[str, SLAM] = {}  # the last pipeline of each sequence
        self._odometry = odometry

    def run(self, sequences: Dict[str, SequenceSource]) -> Dict[str, Dict[str, float]]:
        """Run SLAM over named sequences; returns per-sequence metric dicts."""
        out = {}
        for name, source in sequences.items():
            try:
                out[name] = self._run_sequence(name, source)
            except Exception as exc:  # noqa: BLE001 — the runner must survive
                self.failures[name] = traceback.format_exc()
                if self.config.fail_on_error:
                    raise
                print(f"[SLAMRunner] sequence {name} FAILED: {exc}")
        return out

    def _run_sequence(self, name: str, source: SequenceSource):
        slam = SLAM(self.config.slam, odometry=self._odometry, device=self.device)
        slam.init()
        self.pipelines[name] = slam
        n = len(source)
        if self.config.max_frames is not None:
            n = min(n, self.config.max_frames)

        snap_dir = os.path.join(self.config.log_dir, f"{name}.snapshot")
        start = 0
        if self.config.resume and os.path.exists(os.path.join(snap_dir, "pipeline.npz")):
            slam.restore(snap_dir)
            start = len(getattr(slam.odometry, "results", []) or [])

        gps = None
        if self.config.use_gps:
            if not self.config.slam.with_backend:
                raise ValueError("use_gps requires slam.with_backend=True")
            gps_fn = getattr(source, "gps_poses", None)
            gps = gps_fn() if gps_fn is not None else None
            if gps is None:
                print(f"[SLAMRunner] {name}: use_gps set but source has no GPS stream")

        t0 = time.perf_counter()
        for i in range(start, n):
            gps_i = None
            if gps is not None and i < len(gps) and np.all(np.isfinite(gps[i])):
                gps_i = gps[i]
            slam.process_next_frame(
                source.scan(i),
                absolute_pose_gps=gps_i,
                absolute_information=self.config.gps_information,
            )
            if self.config.save_every_frames and (i + 1) % self.config.save_every_frames == 0:
                write_poses_txt(
                    os.path.join(self.config.log_dir, f"{name}.partial.poses.txt"),
                    slam.absolute_poses(),
                )
                gt_so_far = source.ground_truth()
                if gt_so_far is not None:
                    self.results.add_frames(name, slam.absolute_poses(), gt_so_far[: i + 1])
            if (
                self.config.snapshot_every_frames
                and (i + 1) % self.config.snapshot_every_frames == 0
            ):
                slam.snapshot(snap_dir)
        elapsed = time.perf_counter() - t0
        predicted = slam.absolute_poses()
        gt = source.ground_truth()
        if gt is not None:
            gt = gt[:n]
        md = self.results.add_sequence(name, predicted, gt, elapsed_seconds=elapsed)
        if self.config.gallery:
            scans = _LazyScans(source, n)  # only the sampled frames are loaded
            gallery_dir = os.path.join(self.config.log_dir, f"{name}_gallery")
            write_run_gallery(gallery_dir, name, scans, predicted, gt, metrics=md,
                              device=self.device)
            write_run_player(gallery_dir, name, scans, predicted, gt)
        return md


class _LazyScans:
    """The first ``n`` scans of a source, each read when it is asked for."""

    def __init__(self, source: SequenceSource, n: int):
        self.source, self.n = source, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray(self.source.scan(i))[:, :3]
