#!/usr/bin/env python
"""Run SLAM over dataset sequences with the PyTorch port.

Usage::

    python run_slam_torch.py dataset=kitti root_dir=/data/kitti \\
        sequences=0,1 with_loop_closure=true with_backend=true log_dir=./out

    python run_slam_torch.py config=kitti_loop_backend root_dir=/data/kitti log_dir=./out

    python run_slam_torch.py dataset=synthetic sequences=0 device=cpu log_dir=./out

Config is plain ``key=value`` overrides (Hydra-CLI style) over
:class:`RunConfig`, optionally on top of ``config=<preset>`` YAML files from
``config/``; the resolved config and git hash go into the run directory.
Runs on the card (``device=cuda``) unless ``device=cpu`` is given. The
options of ``run_slam.py`` that the port does not run yet raise
``NotImplementedError`` with the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

# what run_slam.py offers and the port does not run yet, with its ROADMAP item
NOT_PORTED = {
    "dataset": {
        name: f"dataset={name}: data/other_datasets.py and data/rosbag.py, ROADMAP Queue A 9"
        for name in ("kitti360", "nclt", "ford", "nhcd", "rosbag", "urbanloco", "ply_dir",
                     "kitti_carla")
    },
}


@dataclasses.dataclass
class RunConfig:
    """``run_slam.py``'s ``RunConfig``, plus ``device``."""

    dataset: str = "synthetic"  # synthetic | kitti (the others: NOT_PORTED)
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
    batched: bool = False  # BatchedICPOdometry: ROADMAP Queue A 9
    num_points: int = 8192
    snapshot_every_frames: int = 0  # full-pipeline snapshot cadence (0 = off)
    resume: bool = False  # continue a crashed run from its last snapshot
    gallery: bool = False  # evaluation/gallery.py: ROADMAP Queue A 11
    profile_dir: str = ""  # utils/timer.py's profiler trace: ROADMAP Queue A 9
    synthetic_frames: int = 60
    synthetic_trajectory: str = "curve"
    device: str = "cuda"  # cuda | cpu


def check_ported(config: RunConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for an option
    of ``run_slam.py`` that the port does not run yet."""
    for key, table in NOT_PORTED.items():
        if getattr(config, key) in table:
            raise NotImplementedError(table[getattr(config, key)])
    if config.batched:
        raise NotImplementedError("batched=true: BatchedICPOdometry, ROADMAP Queue A 9")
    if config.profile_dir:
        raise NotImplementedError("profile_dir: utils/timer.py, ROADMAP Queue A 9")
    if config.gallery:
        from pwclonet_pylidarslam_torch.slam.runner import GALLERY_NOT_PORTED

        raise NotImplementedError(GALLERY_NOT_PORTED)
    if config.dataset not in ("synthetic", "kitti"):
        raise SystemExit(f"unknown dataset {config.dataset!r}")
    if config.odometry not in ("icp", "ct_icp", "ct_icp_rigid", "pwclonet", "posenet"):
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


def build_sources(config: RunConfig) -> dict:
    check_ported(config)
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
                )
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
    else:
        from pwclonet_pylidarslam_torch.data.kitti import KittiSequence

        for s in seqs:
            sources[f"{int(s):02d}"] = KittiSequence(config.root_dir, int(s))
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
    check_ported(config)

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
    )
    odometry = make_odometry(config, slam_cfg)
    runner = SLAMRunner(runner_cfg, odometry=odometry, device=config.device)
    os.makedirs(config.log_dir, exist_ok=True)
    dump_config(config, f"{config.log_dir}/config.yaml")

    results = runner.run(build_sources(config))
    for name, md in results.items():
        if md:
            print(f"{name}: t_rel={md.get('tr_err', float('nan')):.4f}% ATE={md['ATE']:.4f} m")
    if runner.failures:
        print(f"FAILED sequences: {list(runner.failures)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
