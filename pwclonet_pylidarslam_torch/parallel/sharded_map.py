"""Row-sharded voxel map: the voxel-hash NN map over the ranks of a mesh
axis.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/sharded_map.py``.
The bucket table of ``slam/local_map.py`` is split by contiguous ranges of
hash rows: rank i holds rows ``[i·R, (i+1)·R)``, ``R = table_size / n``, so

- the map's capacity grows with the ranks (a rank holds ``R × bucket_cap``
  points);
- a build needs no communication: each rank buckets, with
  ``local_map.scatter_buckets``, only the points that hash into its range,
  and its rows are those rows of ``local_map.build_voxel_table``, bit for
  bit (same rows, same bucket order);
- a query gathers its neighbour buckets inside the rank's range (the others
  fall on a sentinel bucket of 1e9 points), takes the rank's winner, and
  joins the ranks' winners ``(d², target, normal)`` with one all-gather:
  the least d², the lower rank on a tie, as the reference.

Every rank calls these functions with the same replicated inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from pwclonet_pylidarslam_torch.core.pointcloud import floor_voxels, voxel_hash
from pwclonet_pylidarslam_torch.parallel.mesh import all_gather_rows, axis_rows, mesh_axis
from pwclonet_pylidarslam_torch.slam.local_map import (
    VoxelTable,
    neighbor_bucket_hashes,
    scatter_buckets,
)

_SENTINEL = 1e9


def build_voxel_table_sharded(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    mesh: DeviceMesh,
    axis: str = "data",
    table_size: int = 1 << 16,
    bucket_cap: int = 8,
) -> VoxelTable:
    """This rank's rows of the voxel table of ``points/normals (M, 3)``,
    ``valid (M,)``: a :class:`VoxelTable` of ``(table_size / n, bucket_cap,
    3)``, rows ``[i·R, (i+1)·R)`` of ``build_voxel_table``'s. A
    ``ValueError`` where ``table_size`` does not divide by the axis."""
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    ax = mesh_axis(mesh, axis)
    mine = axis_rows(table_size, ax, "table_size")
    row = voxel_hash(floor_voxels(points, voxel_size)) & (table_size - 1)
    local = row - mine.start
    keep = (valid > 0) & (local >= 0) & (local < mine.stop - mine.start)
    return scatter_buckets(points, normals, keep, local, mine.stop - mine.start, bucket_cap)


def gather_voxel_table(table: VoxelTable, mesh: DeviceMesh, axis: str = "data") -> VoxelTable:
    """The whole table from the ranks' rows (an all-gather): what
    ``build_voxel_table`` gives."""
    ax = mesh_axis(mesh, axis)
    return VoxelTable(*(all_gather_rows(x, ax).flatten(0, 1) for x in table))


def voxel_nn_sharded(
    table: VoxelTable,
    query: torch.Tensor,
    voxel_size: float,
    max_distance: float,
    mesh: DeviceMesh,
    axis: str = "data",
    neighborhood: int = 27,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest stored point of each ``query (N, 3)`` against the rows this
    rank holds of a row-sharded ``table``; the same contract as
    ``local_map.voxel_nn`` (targets, normals, weights, replicated)."""
    ax = mesh_axis(mesh, axis)
    rows, bucket_cap = table.points.shape[:2]
    n = query.shape[0]
    h = neighbor_bucket_hashes(query, voxel_size, rows * ax.size, neighborhood)
    local = h - ax.rank * rows
    hl = torch.where((local >= 0) & (local < rows), local, rows)  # misses: the sentinel row
    pts = torch.cat([table.points, table.points.new_full((1, bucket_cap, 3), _SENTINEL)])
    nrm = torch.cat([table.normals, table.normals.new_zeros((1, bucket_cap, 3))])
    cand = pts[hl].reshape(n, -1, 3)
    d2 = torch.sum((cand - query[:, None, :]) ** 2, dim=-1)
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, 1, best[:, None])
    target = torch.gather(cand, 1, best[:, None, None].expand(n, 1, 3))[:, 0]
    best_bucket = torch.gather(hl, 1, (best // bucket_cap)[:, None])[:, 0]
    normal = nrm[best_bucket, best % bucket_cap]

    # the ranks' winners, joined by one all-gather: (n_ranks, N, 7)
    won = all_gather_rows(torch.cat([best_d2, target, normal], dim=-1), ax)
    win = torch.argmin(won[..., 0], dim=0)  # the first (lowest) rank on a tie
    pick = torch.gather(won, 0, win[None, :, None].expand(1, n, 7))[0]
    d2_w, t_w, n_w = pick[:, 0], pick[:, 1:4], pick[:, 4:7]
    ok = (d2_w < max_distance * max_distance) & (torch.linalg.norm(n_w, dim=-1) > 0.5)
    return t_w, n_w, ok.to(query.dtype)
