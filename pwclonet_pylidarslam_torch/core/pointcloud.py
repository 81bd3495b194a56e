"""Voxel-grid operations: hashing, grid sampling, per-voxel statistics.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/pointcloud.py``.
Dynamic-size results become masks over fixed shapes: ``grid_sample_mask``
selects one point per occupied voxel, and ``voxel_statistics`` reduces over
a fixed number of segments.

The hash is the 3-prime spatial hash of Niessner et al. over int32 voxel
coordinates, with the int32 wrap-around of its multiplications: the
products are taken in int64, and the low 32 bits are read back as an int32
in two's complement. Every sort is stable, so the lowest index wins ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_P1, _P2, _P3 = 73856093, 19349669, 83492791
INT32_MAX = 2**31 - 1


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as an int32 in two's complement."""
    low = x & 0xFFFFFFFF
    return torch.where(low >= 2**31, low - 2**32, low).to(torch.int32)


def _scale(points: torch.Tensor, vx: float, vy: float, vz: float) -> torch.Tensor:
    if vx == vy == vz:
        return points / vx
    return torch.stack([points[..., 0] / vx, points[..., 1] / vy, points[..., 2] / vz], -1)


def voxelise(
    points: torch.Tensor,
    voxel_x: float,
    voxel_y: float = -1.0,
    voxel_z: float = -1.0,
) -> torch.Tensor:
    """Round-to-grid int32 voxel coordinates ``(..., N, 3)``."""
    if voxel_y <= 0:
        voxel_y = voxel_x
    if voxel_z <= 0:
        voxel_z = voxel_x
    return torch.round(_scale(points, voxel_x, voxel_y, voxel_z)).to(torch.int32)


def floor_voxels(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Floor-to-grid int32 voxel coordinates ``(..., N, 3)``."""
    return torch.floor(points / voxel_size).to(torch.int32)


def voxel_hash(voxels: torch.Tensor) -> torch.Tensor:
    """3-prime hash of int voxel coords ``(..., N, 3)`` to ``(..., N)`` int32."""
    v = voxels.to(torch.int64)
    return wrap_int32(_P1 * v[..., 0] + _P2 * v[..., 1] + _P3 * v[..., 2])


def planar_hash(voxels: torch.Tensor) -> torch.Tensor:
    """2D pillar hash over (x, y)."""
    v = voxels.to(torch.int64)
    return wrap_int32(_P1 * v[..., 0] + _P2 * v[..., 1])


def grid_sample_mask(
    points: torch.Tensor,
    voxel_size: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One point per voxel: boolean mask ``(..., N)`` keeping the
    lowest-index point of each voxel (of each row, with leading axes).
    Invalid points go to the sentinel hash ``INT32_MAX``, which is never
    kept."""
    h = voxel_hash(voxelise(points, voxel_size))
    if valid is not None:
        h = torch.where(valid > 0, h, INT32_MAX)
    h_sorted, order = torch.sort(h, dim=-1, stable=True)
    first = torch.ones_like(h_sorted, dtype=torch.bool)
    first[..., 1:] = h_sorted[..., 1:] != h_sorted[..., :-1]
    if valid is not None:
        first = first & (h_sorted != INT32_MAX)
    return torch.zeros_like(first).scatter_(-1, order, first)


class VoxelStats(NamedTuple):
    counts: torch.Tensor  # (S,) points per segment
    means: torch.Tensor  # (S, 3)
    covs: torch.Tensor  # (S, 3, 3)
    segment_ids: torch.Tensor  # (N,) segment of each input point


def voxel_statistics(
    points: torch.Tensor,
    voxel_size: float,
    max_voxels: int,
    valid: Optional[torch.Tensor] = None,
) -> VoxelStats:
    """Per-voxel count, mean and covariance by segment sums.

    Segments are numbered in hash order; voxels beyond ``max_voxels``
    distinct hashes alias into the last segment. The sums are
    ``index_add_``, whose order of addition on CUDA is not fixed.
    """
    n = points.shape[0]
    h = voxel_hash(voxelise(points, voxel_size))
    if valid is not None:
        h = torch.where(valid > 0, h, INT32_MAX)
    h_sorted, order = torch.sort(h, stable=True)
    new_seg = torch.zeros_like(h_sorted)
    new_seg[1:] = (h_sorted[1:] != h_sorted[:-1]).to(h_sorted.dtype)
    seg_sorted = torch.clamp_max(torch.cumsum(new_seg, 0), max_voxels - 1)
    seg = torch.zeros(n, dtype=torch.int64, device=points.device)
    seg[order] = seg_sorted

    w = torch.ones(n, dtype=points.dtype, device=points.device)
    if valid is not None:
        w = w * (valid > 0)

    def segment_sum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((max_voxels,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return out.index_add_(0, seg, x)

    counts = segment_sum(w)
    means = segment_sum(points * w[:, None]) / torch.clamp_min(counts[:, None], 1.0)
    outer = points[:, :, None] * points[:, None, :] * w[:, None, None]
    second = segment_sum(outer)
    covs = second / torch.clamp_min(counts[:, None, None], 1.0) - (
        means[:, :, None] * means[:, None, :]
    )
    return VoxelStats(counts=counts, means=means, covs=covs, segment_ids=seg.to(torch.int32))


def grid_sample_fixed(
    points: torch.Tensor,
    voxel_size: float,
    num_samples: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid sample to a fixed size: the first ``num_samples`` voxel
    representatives by point index, zero-padded. Returns
    ``(sampled (num_samples, 3), mask (num_samples,))``."""
    n = points.shape[0]
    keep = grid_sample_mask(points, voxel_size, valid)
    rank = torch.where(keep, torch.arange(n, device=points.device), n)
    take = torch.sort(rank, stable=True).indices[:num_samples]
    ok = keep[take]
    sampled = torch.where(ok[:, None], points[take], 0.0)
    return sampled, ok.to(points.dtype)
