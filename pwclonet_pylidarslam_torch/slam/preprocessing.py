"""Preprocessing filters: de-skew, grid sampling, voxel statistics.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/preprocessing.py``:
each filter is a function over ``(points, mask, aux)`` and
:class:`Preprocessing` composes the configured ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pwclonet_pylidarslam_torch.core import rotation as rot
from pwclonet_pylidarslam_torch.core.geometry import estimate_timestamps
from pwclonet_pylidarslam_torch.core.pointcloud import grid_sample_mask, voxel_statistics


def deskew(
    points: torch.Tensor,
    relative_pose: torch.Tensor,
    timestamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Motion de-skew by per-point pose interpolation.

    ``relative_pose`` is the motion over the sweep. Each point is
    re-expressed at the scan-end pose: rotation slerped, translation linear
    over its timestamp fraction (estimated from azimuth by default).
    """
    if timestamps is None:
        timestamps = estimate_timestamps(points)
    tmin = torch.amin(timestamps)
    tmax = torch.amax(timestamps)
    alpha = torch.where(
        tmax - tmin > 0, (timestamps - tmin) / torch.clamp_min(tmax - tmin, 1e-12), 0.0
    )
    q_identity = torch.zeros(4, dtype=points.dtype, device=points.device)
    q_identity[0] = 1.0
    q_rel = rot.mat_to_quat(relative_pose[:3, :3]).to(points.dtype)
    q_interp = rot.quat_slerp(
        q_identity.expand(alpha.shape + (4,)), q_rel.expand(alpha.shape + (4,)), alpha
    )
    rotated = rot.quat_rotate(q_interp, points[..., None, :])[..., 0, :]
    return rotated + alpha[..., None] * relative_pose[:3, 3].to(points.dtype)


def grid_sample_filter(points: torch.Tensor, mask: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Keep one point per voxel: the updated validity mask."""
    keep = grid_sample_mask(points, voxel_size, mask)
    return mask * keep.to(mask.dtype)


def voxelization_stats(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                       max_voxels: int):
    """Per-voxel statistics of the valid points."""
    return voxel_statistics(points, voxel_size, max_voxels, mask)


@dataclasses.dataclass(frozen=True)
class PreprocessingConfig:
    deskew: bool = False
    grid_sample_voxel: float = 0.0  # 0 disables


class Preprocessing:
    """Composes the configured filters."""

    def __init__(self, config: PreprocessingConfig = PreprocessingConfig()):
        self.config = config

    def __call__(
        self,
        points: torch.Tensor,
        mask: torch.Tensor,
        init_rpose: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.config.deskew and init_rpose is not None:
            points = torch.where(mask[..., None] > 0, deskew(points, init_rpose), points)
        if self.config.grid_sample_voxel > 0:
            mask = grid_sample_filter(points, mask, self.config.grid_sample_voxel)
        return points, mask
