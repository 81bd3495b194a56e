"""Point-sharded rigid alignment: ICP's Gauss-Newton over the ranks of a
mesh axis.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/sharded_icp.py``.
The correspondences of one alignment ``(B, N, ...)`` are split over the N
axis: each rank builds the normal equations of its ``N/n`` points, H and g
are summed over the axis by one all-reduce an iteration, and every rank
solves the same 6×6 systems (``core/optimization.py::gauss_newton_se3``'s
``reduce``). Every rank calls these functions with the same global inputs
and gets the same replicated result. On one rank the result is that of
:func:`~core.optimization.solve_point_to_plane` (resp. ``_point``), bit for
bit; on more, H and g are summed in another order.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from pwclonet_pylidarslam_torch.core.optimization import (
    SE3GNResult,
    solve_point_to_plane,
    solve_point_to_point,
)
from pwclonet_pylidarslam_torch.parallel.mesh import all_reduce_sum, axis_rows, mesh_axis


def _solve_sharded(solve: Callable, points: tuple, mesh: DeviceMesh,
                   mask: Optional[torch.Tensor], init_pose: Optional[torch.Tensor], axis: str,
                   gn_kwargs: dict) -> SE3GNResult:
    ax = mesh_axis(mesh, axis)
    rows = axis_rows(points[0].shape[1], ax, "point count")
    local = tuple(x[:, rows] for x in points)
    return solve(*local, mask=None if mask is None else mask[:, rows], init_pose=init_pose,
                 reduce=functools.partial(all_reduce_sum, group=ax.group), **gn_kwargs)


def solve_point_to_plane_sharded(
    source: torch.Tensor,
    target: torch.Tensor,
    normals: torch.Tensor,
    mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None,
    init_pose: Optional[torch.Tensor] = None,
    axis: str = "data",
    **gn_kwargs,
) -> SE3GNResult:
    """Point-to-plane alignment of ``source/target/normals (B, N, 3)`` (and
    ``mask (B, N)``) with the N axis split over ``mesh`` axis ``axis``; a
    ``ValueError`` where N does not divide. Drop-in for
    :func:`~core.optimization.solve_point_to_plane`."""
    return _solve_sharded(solve_point_to_plane, (source, target, normals), mesh, mask,
                          init_pose, axis, gn_kwargs)


def solve_point_to_point_sharded(
    source: torch.Tensor,
    target: torch.Tensor,
    mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None,
    init_pose: Optional[torch.Tensor] = None,
    axis: str = "data",
    **gn_kwargs,
) -> SE3GNResult:
    """Point-to-point variant (drop-in for ``solve_point_to_point``)."""
    return _solve_sharded(solve_point_to_point, (source, target), mesh, mask, init_pose,
                          axis, gn_kwargs)
