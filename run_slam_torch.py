#!/usr/bin/env python
"""Run SLAM over dataset sequences with the PyTorch port.

Usage::

    python run_slam_torch.py dataset=kitti root_dir=/data/kitti \\
        sequences=0,1 with_loop_closure=true with_backend=true log_dir=./out

    python run_slam_torch.py config=kitti_loop_backend root_dir=/data/kitti log_dir=./out

    python run_slam_torch.py dataset=synthetic sequences=0 device=cpu log_dir=./out

    python run_slam_torch.py config=kitti_batched dataset=synthetic \
        sequences=0,1,2 synthetic_frames=32 profile_dir=./prof log_dir=./out

    python run_slam_torch.py config=nclt_voxel root_dir=/data/nclt \
        sequences=2012-01-08 gallery=true log_dir=./out

Config is plain ``key=value`` overrides (Hydra-CLI style) over
:class:`RunConfig`, optionally on top of ``config=<preset>`` YAML files from
``config/``; the resolved config and git hash go into the run directory.
Runs on the card (``device=cuda``) unless ``device=cpu`` is given.
``batched=true`` advances every sequence together through
``BatchedICPOdometry`` (odometry only); ``profile_dir`` records a
``torch.profiler`` trace of the run there; ``gallery=true`` writes each
sequence's HTML gallery and player (matplotlib needed). The datasets are
``run_slam.py``'s: ``synthetic``, ``kitti``, ``kitti360``, ``nclt``, ``ford``,
``nhcd``, ``rosbag`` (with ``rosbag_topic``), ``urbanloco``, ``ply_dir`` and
``kitti_carla``, with its sequence names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

from pwclonet_pylidarslam_torch.data import other_datasets as od
from pwclonet_pylidarslam_torch.data.rosbag import RosbagSequence, UrbanLocoSequence

DATASETS = ("synthetic", "kitti", "kitti360", "nclt", "ford", "nhcd", "rosbag", "urbanloco",
            "ply_dir", "kitti_carla")
ODOMETRIES = ("icp", "ct_icp", "ct_icp_rigid", "pwclonet", "posenet")


@dataclasses.dataclass
class RunConfig:
    """``run_slam.py``'s ``RunConfig``, plus ``device``."""

    dataset: str = "synthetic"  # one of DATASETS
    root_dir: str = ""
    rosbag_topic: str = "/velodyne_points"
    sequences: str = "0"  # comma-separated
    log_dir: str = "./slam_output"
    max_frames: int = 0  # 0 = all
    odometry: str = "icp"  # icp | ct_icp | ct_icp_rigid | pwclonet | posenet
    checkpoint_dir: str = ""  # train_net_torch.py log_dir (odometry=pwclonet|posenet)
    fused_eval: bool = False  # pwclonet: the fused eval kernels
    vm_height: int = 64  # posenet vertex-map shape
    vm_width: int = 720
    association: str = "projective"  # projective | voxel
    bev_bootstrap: bool = False  # in-graph BEV prior for fast rotation (icp only)
    max_num_alignments: int = 15  # outer ICP iterations (icp only)
    with_loop_closure: bool = False
    with_backend: bool = False
    # GPS-constrained SLAM: the source's gps_poses() as back-end priors;
    # dataset=synthetic simulates a fix every gps_stride frames with
    # gps_noise m of position noise
    gps: bool = False
    gps_stride: int = 10
    gps_noise: float = 0.05
    # every sequence in one batched step a frame (BatchedICPOdometry);
    # odometry only, the sequences cut to the shortest
    batched: bool = False
    num_points: int = 8192
    snapshot_every_frames: int = 0  # full-pipeline snapshot cadence (0 = off)
    resume: bool = False  # continue a crashed run from its last snapshot
    gallery: bool = False  # each sequence's HTML gallery and player (evaluation/gallery.py)
    profile_dir: str = ""  # a torch.profiler trace of the run (utils/timer.py)
    synthetic_frames: int = 60
    synthetic_trajectory: str = "curve"
    device: str = "cuda"  # cuda | cpu


def check_config(config: RunConfig) -> None:
    """Exit on an unknown dataset or odometry."""
    if config.dataset not in DATASETS:
        raise SystemExit(f"unknown dataset {config.dataset!r}")
    if config.odometry not in ODOMETRIES:
        raise SystemExit(f"unknown odometry {config.odometry!r}")


class _Source:
    def __init__(self, scans, gt, gps=None):
        self.scans, self.gt, self._gps = scans, gt, gps

    def __len__(self):
        return len(self.scans)

    def scan(self, idx):
        return self.scans[idx]

    def ground_truth(self):
        return self.gt

    def gps_poses(self):
        return self._gps


def _bag_name(s: str) -> str:
    return s.rsplit("/", 1)[-1].removesuffix(".bag")


def build_sources(config: RunConfig) -> dict:
    """The named sequences of ``config.dataset``, named as ``run_slam.py``
    names them."""
    check_config(config)
    seqs = [s for s in str(config.sequences).strip("[]").split(",") if s != ""]
    sources = {}
    if config.dataset == "synthetic":
        from pwclonet_pylidarslam_torch.data.synthetic import (
            SyntheticSequenceConfig,
            generate_sequence,
        )

        for s in seqs:
            scans, gt = generate_sequence(
                SyntheticSequenceConfig(
                    n_frames=config.synthetic_frames,
                    trajectory=config.synthetic_trajectory,
                    seed=int(s),
                    num_points=config.num_points,
                ),
                device=config.device,
            )
            gps = None
            if config.gps:
                # simulated GPS: GT position + noise every gps_stride frames,
                # NaN elsewhere (no fix)
                r = np.random.default_rng(int(s) + 1)
                gps = np.full_like(gt, np.nan)
                for t in range(0, len(gt), config.gps_stride):
                    fix = gt[t].copy()
                    fix[:3, 3] += r.normal(scale=config.gps_noise, size=3)
                    gps[t] = fix
            sources[f"synth{int(s):02d}"] = _Source(scans, gt, gps)
    elif config.dataset == "kitti":
        from pwclonet_pylidarslam_torch.data.kitti import KittiSequence

        for s in seqs:
            sources[f"{int(s):02d}"] = KittiSequence(config.root_dir, int(s))
    elif config.dataset == "kitti360":
        for s in seqs:
            sources[f"{int(s):02d}"] = od.Kitti360Sequence(config.root_dir, int(s))
    elif config.dataset == "nclt":
        for s in seqs:
            sources[s] = od.NCLTSequence(config.root_dir, s)
    elif config.dataset == "ford":
        for s in seqs:
            sources[s] = od.FordCampusSequence(os.path.join(config.root_dir, s))
    elif config.dataset == "nhcd":
        for s in seqs:
            sources[s] = od.NHCDSequence(config.root_dir, s)
    elif config.dataset == "rosbag":
        for s in seqs:  # each "sequence" is a bag path relative to root_dir
            path = f"{config.root_dir}/{s}" if config.root_dir else s
            sources[_bag_name(s)] = RosbagSequence(path, config.rosbag_topic,
                                                   num_points=config.num_points)
    elif config.dataset == "urbanloco":
        for s in seqs:
            path = f"{config.root_dir}/{s}" if config.root_dir else s
            acq = (UrbanLocoSequence.CALIFORNIA if _bag_name(s).startswith("CA")
                   else UrbanLocoSequence.HONG_KONG)
            sources[_bag_name(s)] = UrbanLocoSequence(path, acq, num_points=config.num_points)
    elif config.dataset == "ply_dir":
        for s in seqs:  # each "sequence" is a scan dir relative to root_dir
            scan_dir = os.path.join(config.root_dir, s) if config.root_dir else s
            poses = os.path.join(os.path.dirname(scan_dir.rstrip("/")), "poses.txt")
            sources[s.rstrip("/").rsplit("/", 1)[-1]] = od.PLYDirSequence(
                scan_dir, poses if os.path.exists(poses) else None)
    else:  # kitti_carla
        for s in seqs:
            sources[f"Town{int(s):02d}"] = od.KittiCarlaSequence(config.root_dir, int(s))
    return sources


def make_odometry(config: RunConfig, slam_cfg):
    """The odometry the config names, on its device (``slam_cfg.odometry``
    is set for ICP)."""
    if config.odometry == "pwclonet":
        from pwclonet_pylidarslam_torch.models import scaled_model_config
        from pwclonet_pylidarslam_torch.slam.deep_odometry import (
            DeepOdometryConfig,
            PWCLONetOdometry,
        )
        from pwclonet_pylidarslam_torch.train.state import TrainConfig
        from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig

        if not config.checkpoint_dir:
            raise SystemExit("odometry=pwclonet requires checkpoint_dir=<train_net_torch log_dir>")
        model_cfg = scaled_model_config(config.num_points, fused_eval=config.fused_eval)
        trainer = PWCLONetTrainer(
            TrainerConfig(train=TrainConfig(model=model_cfg), log_dir=config.checkpoint_dir),
            device=config.device,
        )
        trainer.load_checkpoint()
        return PWCLONetOdometry(
            trainer.state.state_dict(),
            DeepOdometryConfig(model=model_cfg, num_points=config.num_points),
            device=config.device,
        )
    if config.odometry == "posenet":
        from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
        from pwclonet_pylidarslam_torch.slam.deep_odometry import (
            PoseNetOdometry,
            PoseNetOdometryConfig,
        )
        from pwclonet_pylidarslam_torch.train.posenet_state import PoseNetTrainConfig
        from pwclonet_pylidarslam_torch.train.posenet_trainer import (
            PoseNetTrainer,
            PoseNetTrainerConfig,
        )

        if not config.checkpoint_dir:
            raise SystemExit("odometry=posenet requires checkpoint_dir=<train_net_torch log_dir>")
        projector = SphericalProjector(height=config.vm_height, width=config.vm_width)
        trainer = PoseNetTrainer(
            PoseNetTrainerConfig(
                train=PoseNetTrainConfig(projector=projector),
                vm_shape=(config.vm_height, config.vm_width),
                log_dir=config.checkpoint_dir,
            ),
            device=config.device,
        )
        trainer.load_checkpoint()
        return PoseNetOdometry(trainer.odometry_variables(),
                               PoseNetOdometryConfig(projector=projector), device=config.device)
    if config.odometry in ("ct_icp", "ct_icp_rigid"):
        from pwclonet_pylidarslam_torch.slam import CTICPConfig, CTICPOdometry

        return CTICPOdometry(
            CTICPConfig(num_points=config.num_points, elastic=config.odometry == "ct_icp"),
            device=config.device,
        )
    from pwclonet_pylidarslam_torch.slam.icp_odometry import ICPConfig, ICPOdometry

    slam_cfg.odometry = ICPConfig(
        num_points=config.num_points,
        bev_bootstrap=config.bev_bootstrap,
        association=config.association,
        max_num_alignments=config.max_num_alignments,
    )
    return ICPOdometry(slam_cfg.odometry, device=config.device)


def main(argv: Optional[List[str]] = None) -> int:
    from pwclonet_pylidarslam_torch.slam.pipeline import SLAMConfig
    from pwclonet_pylidarslam_torch.slam.runner import SLAMRunner, SLAMRunnerConfig
    from pwclonet_pylidarslam_torch.utils.config import dump_config, parse_cli

    argv = argv if argv is not None else sys.argv[1:]
    config = parse_cli(RunConfig, argv)
    check_config(config)
    if config.batched:
        if config.with_loop_closure or config.with_backend or config.resume or config.gps:
            raise SystemExit("batched=true is odometry-only (no loop closure/backend/gps/resume)")
        if config.snapshot_every_frames:
            raise SystemExit("batched=true does not support snapshots")
        if config.odometry != "icp":
            raise SystemExit("batched=true supports odometry=icp")
        return run_batched(config)

    slam_cfg = SLAMConfig(
        with_loop_closure=config.with_loop_closure,
        with_backend=config.with_backend or config.gps,
        optimize_on_absolute=config.gps,
    )
    runner_cfg = SLAMRunnerConfig(
        slam=slam_cfg,
        log_dir=config.log_dir,
        max_frames=config.max_frames or None,
        snapshot_every_frames=config.snapshot_every_frames,
        resume=config.resume,
        use_gps=config.gps,
        gallery=config.gallery,
    )
    odometry = make_odometry(config, slam_cfg)
    runner = SLAMRunner(runner_cfg, odometry=odometry, device=config.device)
    os.makedirs(config.log_dir, exist_ok=True)
    dump_config(config, f"{config.log_dir}/config.yaml")

    with _trace(config):
        results = runner.run(build_sources(config))
    for name, md in results.items():
        if md:
            print(f"{name}: t_rel={md.get('tr_err', float('nan')):.4f}% ATE={md['ATE']:.4f} m")
    if runner.failures:
        print(f"FAILED sequences: {list(runner.failures)}")
        return 1
    return 0


def _trace(config: RunConfig):
    """A profiler trace into ``profile_dir`` where one is asked for."""
    if not config.profile_dir:
        return contextlib.nullcontext()
    from pwclonet_pylidarslam_torch.utils.timer import profiler_trace

    return profiler_trace(config.profile_dir, device=config.device)


def run_batched(config: RunConfig) -> int:
    """All sequences advance together: ``BatchedICPOdometry`` over chunks of
    32 frames, the sequences cut to the shortest; each sequence's poses and
    metrics go through ``OdometryResults``."""
    from pwclonet_pylidarslam_torch.evaluation.results import OdometryResults
    from pwclonet_pylidarslam_torch.slam.icp_odometry import BatchedICPOdometry, ICPConfig
    from pwclonet_pylidarslam_torch.utils.config import dump_config

    os.makedirs(config.log_dir, exist_ok=True)
    dump_config(config, f"{config.log_dir}/config.yaml")
    sources = build_sources(config)
    names = list(sources)
    t_total = min(len(src) for src in sources.values())
    if config.max_frames:
        t_total = min(t_total, config.max_frames)
    odo = BatchedICPOdometry(
        ICPConfig(
            num_points=config.num_points,
            association=config.association,
            bev_bootstrap=config.bev_bootstrap,
        ),
        device=config.device,
    )
    odo.init(n_sequences=len(names))
    with _trace(config):
        _run_batched_chunks(config, odo, sources, t_total, chunk=32)
    poses = odo.absolute_poses()
    results = OdometryResults(config.log_dir)
    for i, name in enumerate(names):
        gt = sources[name].ground_truth()
        md = results.add_sequence(name, poses[i], None if gt is None else np.asarray(gt)[:t_total])
        if md:
            print(f"{name}: t_rel={md.get('tr_err', float('nan')):.4f}% ATE={md['ATE']:.4f} m")
    return 0


def _run_batched_chunks(config: RunConfig, odo, sources: dict, t_total: int, chunk: int) -> None:
    """Feed ``odo`` the sequences' frames ``[0, t_total)`` in chunks, each
    scan sized by ``fix_scan_size`` with its frame index as the seed."""
    from pwclonet_pylidarslam_torch.slam.icp_odometry import fix_scan_size

    for start in range(0, t_total, chunk):
        end = min(start + chunk, t_total)
        odo.process_chunk(np.stack([
            np.stack([fix_scan_size(np.asarray(src.scan(t))[:, :3], config.num_points, seed=t)
                      for t in range(start, end)])
            for src in sources.values()
        ]))


if __name__ == "__main__":
    raise SystemExit(main())
