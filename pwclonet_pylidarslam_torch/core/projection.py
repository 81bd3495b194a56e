"""Spherical projection: point clouds to vertex maps, deterministic z-buffer.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/projection.py``, with
the same conventions: ``col = W * 0.5 (−atan2(y,x)/π + 1)``,
``row = H * (1 − (asin(z/r) + |fov_down|)/fov)``, FOV angles in degrees.
Vertex maps are channel-last ``(B, H, W, C)`` with xyz in channels 0..2; a
pixel is empty iff its xyz is 0.

The z-buffer is two ``scatter_reduce_(..., "amin")`` passes, depth first
and then the point index among the depth winners, plus one gather. A
minimum does not depend on the order in which the scatter visits the
points, so the map is the same on the CPU and on CUDA, run after run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def spherical_pixel_coords(
    points: torch.Tensor,
    height: int,
    width: int,
    min_vertical_fov: float,
    max_vertical_fov: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Continuous (row, col) pixel coords and range of ``points (B, N, 3)``.

    Points at the origin (r == 0) get row = col = −1 and range 0.
    """
    r = torch.linalg.norm(points, dim=-1)
    valid = r > 0.0
    r_safe = torch.where(valid, r, 1e-3)
    x, y, z = points.unbind(-1)
    theta = -torch.atan2(y, x)
    phi = torch.asin(torch.clamp(z / r_safe, -1.0, 1.0))
    fov_up = math.radians(min_vertical_fov)
    fov_down = math.radians(max_vertical_fov)
    fov = abs(fov_down) + abs(fov_up)
    col = 0.5 * (theta / math.pi + 1.0) * width
    row = (1.0 - (phi + abs(fov_down)) / fov) * height
    row = torch.where(valid, row, -1.0)
    col = torch.where(valid, col, -1.0)
    return row, col, torch.where(valid, r, 0.0)


def zbuffer_scatter(
    channels: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    depth: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """Scatter ``channels (B, N, C)`` to ``(B, H, W, C)``; the nearest depth
    wins each pixel, and among equal depths the lowest point index.

    Points off the image or with depth 0 go to a dummy slot at ``H·W``,
    which is dropped. Empty pixels stay 0.
    """
    b, n, c = channels.shape
    hw = height * width
    r_i = torch.round(rows).to(torch.int64)
    c_i = torch.round(cols).to(torch.int64)
    valid = (
        (rows >= 0.0)
        & (r_i >= 0)
        & (r_i <= height - 1)
        & (c_i >= 0)
        & (c_i <= width - 1)
        & (depth > 0.0)
    )
    flat = torch.where(valid, r_i * width + c_i, hw)
    key = torch.where(valid, depth, math.inf)
    min_depth = torch.full((b, hw + 1), math.inf, dtype=key.dtype, device=key.device)
    min_depth.scatter_reduce_(1, flat, key, "amin", include_self=True)
    is_winner = key == torch.gather(min_depth, 1, flat)
    index = torch.arange(n, device=flat.device).expand(b, n)
    idx_key = torch.where(is_winner, index, n)
    win_idx = torch.full((b, hw + 1), n, dtype=torch.int64, device=flat.device)
    win_idx.scatter_reduce_(1, flat, idx_key, "amin", include_self=True)
    win_idx = win_idx[:, :hw]
    has_point = win_idx < n
    gathered = torch.gather(
        channels, 1, torch.clamp(win_idx, 0, n - 1)[..., None].expand(b, hw, c)
    )
    out = torch.where(has_point[..., None], gathered, 0.0)
    return out.reshape(b, height, width, c)


@dataclasses.dataclass(frozen=True)
class SphericalProjector:
    """Spherical projector; the default is the KITTI HDL-64 geometry: 64
    rows, 720 columns, vertical FOV +3° (up) / −24° (down)."""

    height: int = 64
    width: int = 720
    min_vertical_fov: float = 3.0
    max_vertical_fov: float = -24.0

    def project(self, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Continuous (row, col, range) of ``points (B, N, 3)``."""
        return spherical_pixel_coords(
            points, self.height, self.width, self.min_vertical_fov, self.max_vertical_fov
        )

    def build_projection_map(
        self, points: torch.Tensor, channels: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Project ``points (B, N, 3)`` (and optional ``channels (B, N, C)``)
        into a ``(B, H, W, 3+C)`` vertex map; the nearest point wins a pixel."""
        rows, cols, depth = self.project(points)
        chan = points if channels is None else torch.cat([points, channels], -1)
        return zbuffer_scatter(chan, rows, cols, depth, self.height, self.width)

    def build_vertex_map(self, points: torch.Tensor) -> torch.Tensor:
        return self.build_projection_map(points)


def vmap_depth(vertex_map: torch.Tensor) -> torch.Tensor:
    """Per-pixel range ``(B, H, W)`` of a vertex map; 0 where empty."""
    return torch.linalg.norm(vertex_map[..., :3], dim=-1)


def vmap_mask(vertex_map: torch.Tensor) -> torch.Tensor:
    """Validity mask ``(B, H, W)``: the pixel holds a real point."""
    return (vmap_depth(vertex_map) > 0.0).to(vertex_map.dtype)


def vmap_to_points(vertex_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten ``(B, H, W, C)`` to ``(B, H·W, C)`` points and a ``(B, H·W)`` mask."""
    b, h, w, c = vertex_map.shape
    pts = vertex_map.reshape(b, h * w, c)
    mask = (torch.linalg.norm(pts[..., :3], dim=-1) > 0.0).to(vertex_map.dtype)
    return pts, mask


def density_matched_projector(num_points: int) -> SphericalProjector:
    """Vertex-map resolution matched to scan density (~8 points a pixel);
    8192 points give the full-size 64x720 map."""
    h = 64 if num_points >= 4096 else 32
    w = max(64, min(720, (num_points * 8 // h) // 64 * 64))
    return SphericalProjector(height=h, width=w)
