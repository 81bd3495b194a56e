"""Controlled odometry-drift injection for end-to-end back-end validation.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/drift_injection.py``,
whose docstring gives the reasons: ICP odometry on synthetic worlds is too
accurate for a loop-closure + pose-graph run to show a measurable benefit,
and degraded scans poison the refinement as much as the odometry.
:class:`DriftingICPOdometry` instead warps the WHOLE odometry state (current
pose, keyframe poses, cached model frame) after every frame by a world
transform equal to a fixed local-frame bias at the current pose. The map
drifts with the pose, so ICP cannot cancel the bias, while the scans stay
clean and loop constraints stay accurate: the back end then has the job it
has on a real drifting platform.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.slam.icp_odometry import ICPConfig, ICPOdometry


def yaw_bias(yaw_deg: float = 0.15, dx: float = 0.01) -> np.ndarray:
    """A small local-frame SE(3) bias: ``yaw_deg`` of heading error plus
    ``dx`` meters of longitudinal scale error per frame."""
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    bias = np.eye(4)
    bias[:2, :2] = [[c, -s], [s, c]]
    bias[0, 3] = dx
    return bias


class DriftingICPOdometry(ICPOdometry):
    """ICP odometry with a deliberate per-frame bias folded into its state.

    The bias is applied as ``C = pose · B · pose⁻¹`` (the local bias
    expressed as a world transform) to every absolute pose the state
    carries: the set ``SLAM._resync_odometry`` corrects.
    """

    def __init__(self, config: Optional[ICPConfig] = None, bias: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(config, device=device)
        self._bias = np.asarray(bias if bias is not None else yaw_bias(), np.float64)

    def process_next_frame(self, points: np.ndarray) -> np.ndarray:
        super().process_next_frame(points)
        state = self.state
        old = state.pose.cpu().numpy().astype(np.float64)
        c = old @ self._bias @ np.linalg.inv(old)
        cj = torch.as_tensor(c, dtype=state.pose.dtype, device=state.pose.device)
        self.state = state._replace(
            pose=cj @ state.pose,
            last_kf_pose=cj @ state.last_kf_pose,
            model_pose=cj @ state.model_pose,
            map=state.map._replace(poses=cj[None] @ state.map.poses),
        )
        self.host_reads[-1] += 2  # the state's pose, and the biased one returned
        return self.state.pose.cpu().numpy().astype(np.float64)


def scenario_ground_truth(n_frames: int = 80) -> np.ndarray:
    """The ground-truth poses ``(T, 4, 4)`` of :func:`run_drift_scenario`'s
    there-and-back trajectory."""
    from pwclonet_pylidarslam_torch.data.synthetic import make_trajectory

    return make_trajectory("there_and_back", n_frames, 1.6)


def anchored_errors(poses: np.ndarray, gt: np.ndarray, anchor: int = 0) -> np.ndarray:
    """Per-frame translation error of ``poses`` against ``gt`` once both are
    aligned at frame ``anchor`` (``anchor=0`` is the plain error of an
    estimate that starts at the identity). Anchored at frame 1, the error
    leaves out the first odometry step, which no loop constraint observes."""
    aligned = gt[anchor] @ np.linalg.inv(poses[anchor]) @ poses
    return np.linalg.norm(aligned[:, :3, 3] - gt[: len(poses), :3, 3], axis=1)


def run_drift_scenario(with_backend: bool, n_frames: int = 80, seed: int = 5,
                       device: Union[str, torch.device] = "cuda"):
    """The reference's drift-injection closed-loop scenario, exactly as it
    defines it: a there-and-back world at 2048 points, biased odometry,
    loop closure on; the back end toggles. Returns ``(slam, per-frame
    translation error against ground truth)``."""
    from pwclonet_pylidarslam_torch.core.registration import BEVConfig
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence,
    )
    from pwclonet_pylidarslam_torch.slam.loop_closure import LoopClosureConfig
    from pwclonet_pylidarslam_torch.slam.pipeline import SLAM, SLAMConfig

    scans, gt = generate_sequence(
        SyntheticSequenceConfig(
            n_frames=n_frames, trajectory="there_and_back", speed=1.6, seed=seed,
            num_points=2048,
        )
    )
    lc_cfg = LoopClosureConfig(
        submap_size=6, overlap=2, min_id_distance=20, max_distance=30.0,
        points_per_frame=1024, submap_points=4096,
        bev=BEVConfig(pixel_size=0.5, image_size=192),
        min_confidence=1.2, max_icp_rmse=1.0,
    )
    cfg = SLAMConfig(
        odometry=ICPConfig(num_points=2048, initial_assoc_distance=8.0),
        with_loop_closure=True, loop_closure=lc_cfg,
        with_backend=with_backend,
        backend_max_nodes=128, backend_max_edges=256,
    )
    slam = SLAM(cfg, odometry=DriftingICPOdometry(cfg.odometry, yaw_bias(), device=device),
                device=device)
    slam.init()
    for s in scans:
        slam.process_next_frame(s)
    pred = slam.absolute_poses()
    err = np.linalg.norm(pred[:, :3, 3] - gt[: len(pred), :3, 3], axis=1)
    return slam, err
