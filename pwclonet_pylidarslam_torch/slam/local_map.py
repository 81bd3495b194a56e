"""Local maps of ICP odometry: a keyframe ring buffer, its projective model
map and its voxel-hash bucket table.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/local_map.py``. The
map stores the last K keyframes as fixed-size point lists with per-point
normals and absolute poses. Given a query pose, the stored points are
brought into the query frame and either scattered through the z-buffer into
one model map (projective association: a pixel gather per point) or
bucketed by a spatial hash (voxel association: the nearest candidate among
the neighbouring buckets).

States are ``NamedTuple``s of tensors and every function returns new
tensors. The sorts are stable, ties of an ``argmin`` go to the first index,
and each scatter writes every kept destination once: what is dropped goes
to a spill row that is cut off. So a table is the same on the CPU and on
CUDA.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.core.pointcloud import floor_voxels, voxel_hash
from pwclonet_pylidarslam_torch.core.projection import (
    SphericalProjector,
    spherical_pixel_coords,
    zbuffer_scatter,
)

UINT32_MAX = 0xFFFFFFFF


class LocalMapState(NamedTuple):
    """Ring buffer of K keyframes. ``points``/``normals`` are in each
    keyframe's own sensor frame; ``poses`` are absolute."""

    points: torch.Tensor  # (K, P, 3)
    normals: torch.Tensor  # (K, P, 3)
    pt_valid: torch.Tensor  # (K, P)
    poses: torch.Tensor  # (K, 4, 4)
    valid: torch.Tensor  # (K,) float 0/1
    next_slot: torch.Tensor  # () int32, FIFO write pointer


def init_local_map(
    capacity: int, points_per_frame: int, dtype=torch.float32, device="cpu"
) -> LocalMapState:
    return LocalMapState(
        points=torch.zeros((capacity, points_per_frame, 3), dtype=dtype, device=device),
        normals=torch.zeros((capacity, points_per_frame, 3), dtype=dtype, device=device),
        pt_valid=torch.zeros((capacity, points_per_frame), dtype=dtype, device=device),
        poses=torch.eye(4, dtype=dtype, device=device).expand(capacity, 4, 4).clone(),
        valid=torch.zeros((capacity,), dtype=dtype, device=device),
        next_slot=torch.zeros((), dtype=torch.int32, device=device),
    )


def insert_keyframe(
    state: LocalMapState,
    points: torch.Tensor,
    normals: torch.Tensor,
    pt_valid: torch.Tensor,
    pose: torch.Tensor,
    do_insert: torch.Tensor,
) -> LocalMapState:
    """Insert a keyframe at the FIFO slot where ``do_insert`` (a bool
    tensor) holds; otherwise return the same contents. A masked write: the
    slot is selected on the device, with no host read."""
    k = state.points.shape[0]
    slot = state.next_slot.to(torch.int64) % k
    write = (torch.arange(k, device=slot.device) == slot) & do_insert  # (K,)

    def mix(buf, new):
        sel = write.reshape((k,) + (1,) * (buf.dim() - 1))
        return torch.where(sel, new.to(buf.dtype).unsqueeze(0), buf)

    return LocalMapState(
        points=mix(state.points, points),
        normals=mix(state.normals, normals),
        pt_valid=mix(state.pt_valid, pt_valid),
        poses=mix(state.poses, pose),
        valid=torch.where(write, torch.clamp_min(state.valid, 1.0), state.valid),
        next_slot=state.next_slot + do_insert.to(torch.int32),
    )


def _rotate(rot: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``rot (K, 3, 3)`` applied to ``vecs (K, P, 3)``, elementwise."""
    return torch.sum(rot[:, None, :, :] * vecs[:, :, None, :], dim=-1)


def flatten_map_points(
    state: LocalMapState, query_pose: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All stored keyframe points and normals brought into the query frame.
    Returns ``(points (K·P, 3), normals (K·P, 3), valid (K·P,))``."""
    k, p, _ = state.points.shape
    rel = se3.inverse(query_pose)[None] @ state.poses
    pts_q = se3.transform(rel, state.points)
    nrm_q = _rotate(rel[:, :3, :3], state.normals)
    pt_ok = state.pt_valid * state.valid[:, None]
    return pts_q.reshape(k * p, 3), nrm_q.reshape(k * p, 3), pt_ok.reshape(k * p)


def build_model_map(
    state: LocalMapState, query_pose: torch.Tensor, projector: SphericalProjector
) -> torch.Tensor:
    """Aggregate the stored keyframes into one model map ``(H, W, 6)``
    (xyz + normal) in the query frame; the nearest point wins a pixel."""
    flat_pts, flat_nrm, flat_valid = flatten_map_points(state, query_pose)
    rows, cols, depth = spherical_pixel_coords(
        flat_pts[None], projector.height, projector.width,
        projector.min_vertical_fov, projector.max_vertical_fov,
    )
    depth = torch.where(flat_valid[None] > 0, depth, 0.0)
    chan = torch.cat([flat_pts, flat_nrm], dim=-1)[None]
    return zbuffer_scatter(chan, rows, cols, depth, projector.height, projector.width)[0]


def associate(
    model: torch.Tensor,
    points: torch.Tensor,
    projector: SphericalProjector,
    max_distance: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projective association of ``points (N, 3)`` against a model
    ``(H, W, 6)``: each point takes the model pixel it projects to; empty
    pixels and matches at ``max_distance`` or farther are masked out.
    Returns ``(targets (N,3), normals (N,3), weights (N,))``."""
    rows, cols, depth = spherical_pixel_coords(
        points[None], projector.height, projector.width,
        projector.min_vertical_fov, projector.max_vertical_fov,
    )
    r_i = torch.clamp(torch.round(rows[0]).to(torch.int64), 0, projector.height - 1)
    c_i = torch.clamp(torch.round(cols[0]).to(torch.int64), 0, projector.width - 1)
    hit = model[r_i, c_i]
    target, normal = hit[..., :3], hit[..., 3:]
    dist = torch.linalg.norm(points - target, dim=-1)
    ok = (
        (depth[0] > 0)
        & (torch.linalg.norm(target, dim=-1) > 0)
        & (torch.linalg.norm(normal, dim=-1) > 0.5)
        & (dist < max_distance)
    )
    return target, normal, ok.to(points.dtype)


# --- voxel-hash nearest-neighbour map ------------------------------------


class VoxelTable(NamedTuple):
    """Bucketed point store; empty slots hold the 1e9 sentinel point and a
    zero normal."""

    points: torch.Tensor  # (table_size, bucket_cap, 3)
    normals: torch.Tensor  # (table_size, bucket_cap, 3)


def _scatter_table(points, normals, order, dest, rows: int, bucket_cap: int) -> VoxelTable:
    """Write the sorted points to their slots; ``dest`` is unique except
    for the spill slot ``rows·cap``, which is cut off."""
    slots = rows * bucket_cap + 1
    table_pts = torch.full((slots, 3), 1e9, dtype=points.dtype, device=points.device)
    table_nrm = torch.zeros((slots, 3), dtype=normals.dtype, device=normals.device)
    table_pts[dest] = points[order]
    table_nrm[dest] = normals[order]
    return VoxelTable(
        points=table_pts[:-1].reshape(rows, bucket_cap, 3),
        normals=table_nrm[:-1].reshape(rows, bucket_cap, 3),
    )


def scatter_buckets(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid_rows: torch.Tensor,
    row_id: torch.Tensor,
    rows: int,
    bucket_cap: int,
) -> VoxelTable:
    """Bucket ``points (M,3)`` by ``row_id (M,)`` (rows where ``valid_rows``
    is false are dropped) into a ``(rows, bucket_cap, 3)`` store: one stable
    sort, then one scatter. A bucket keeps its ``bucket_cap`` lowest-index
    points."""
    m = points.shape[0]
    h = torch.where(valid_rows, row_id.to(torch.int64), rows)
    h_sorted, order = torch.sort(h, stable=True)
    first_of_bucket = torch.searchsorted(h_sorted, h_sorted, side="left")
    slot = torch.arange(m, device=points.device) - first_of_bucket
    keep = (slot < bucket_cap) & (h_sorted < rows)
    dest = h_sorted * bucket_cap + torch.clamp(slot, 0, bucket_cap - 1)
    dest = torch.where(keep, dest, rows * bucket_cap)
    return _scatter_table(points, normals, order, dest, rows, bucket_cap)


def build_voxel_table(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    table_size: int = 1 << 16,
    bucket_cap: int = 8,
) -> VoxelTable:
    """Bucket ``points (M, 3)`` by the spatial hash of their
    ``voxel_size`` cell; ``valid (M,)`` 0/1 rows. Points past a bucket's
    ``bucket_cap`` are dropped."""
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    row_id = voxel_hash(floor_voxels(points, voxel_size)) & (table_size - 1)
    return scatter_buckets(points, normals, valid > 0, row_id, table_size, bucket_cap)


def build_voxel_table_fused(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    sample_size: float,
    table_size: int = 1 << 16,
    bucket_cap: int = 8,
) -> VoxelTable:
    """Bucket by spatial hash and grid-sample (one point per
    ``sample_size`` sub-cell) in one sort over a composite
    ``(bucket_row, subcell)`` key.

    The key is the reference's uint32, bit for bit: the row in the high
    bits and the subcell hash cut to ``31 - log2(table_size)`` bits below
    it, invalid points at the sentinel ``0xFFFFFFFF``. torch has almost no
    uint32 arithmetic, so the key is held as int64 values of the same bits,
    which sort in the same order. Dedup is per (bucket, subcell), the lowest
    index wins, and a bucket keeps its first ``bucket_cap`` winners in key
    order.
    """
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    row_bits = int(table_size - 1).bit_length()
    sub_bits = 31 - row_bits
    row = (voxel_hash(floor_voxels(points, voxel_size)) & (table_size - 1)).to(torch.int64)
    sub = voxel_hash(floor_voxels(points, sample_size)).to(torch.int64) & UINT32_MAX
    sub = sub & ((1 << sub_bits) - 1)
    key = torch.where(valid > 0, (row << sub_bits) | sub, UINT32_MAX)
    key_sorted, order = torch.sort(key, stable=True)
    ok_sorted = key_sorted != UINT32_MAX
    new_group = torch.ones_like(ok_sorted)
    new_group[1:] = key_sorted[1:] != key_sorted[:-1]
    first_keep = new_group & ok_sorted
    row_sorted = key_sorted >> sub_bits
    first_of_row = torch.searchsorted(row_sorted, row_sorted, side="left")
    keep_i = first_keep.to(torch.int64)
    kept_before = torch.cumsum(keep_i, 0) - keep_i
    slot = kept_before - kept_before[first_of_row]
    keep = first_keep & (slot < bucket_cap)
    dest = row_sorted * bucket_cap + torch.clamp(slot, 0, bucket_cap - 1)
    dest = torch.where(keep, dest, table_size * bucket_cap)
    return _scatter_table(points, normals, order, dest, table_size, bucket_cap)


def _octant_offsets(device) -> torch.Tensor:
    i = torch.arange(8, device=device)
    return torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], -1)


def _cube_offsets(device) -> torch.Tensor:
    i = torch.arange(27, device=device)
    return torch.stack([i // 9 - 1, (i // 3) % 3 - 1, i % 3 - 1], -1)


def neighbor_bucket_hashes(
    query: torch.Tensor, voxel_size: float, table_size: int, neighborhood: int
) -> torch.Tensor:
    """Table rows of each query's neighbour buckets ``(N, k)``.

    ``neighborhood=8``: the half-offset 2x2x2 cells of ``2·voxel_size``
    nearest to the query (build the table with that cell size); ``27``: the
    3x3x3 cells of ``voxel_size``. Offsets run x, then y, then z fastest.
    """
    if neighborhood == 8:
        t = query / (2.0 * voxel_size)
        c = torch.floor(t).to(torch.int32)
        shift = torch.where(t - c >= 0.5, 0, -1).to(torch.int32)
        neigh = (c + shift)[:, None, :] + _octant_offsets(query.device)[None].to(torch.int32)
    else:
        vox_q = floor_voxels(query, voxel_size)
        neigh = vox_q[:, None, :] + _cube_offsets(query.device)[None].to(torch.int32)
    return (voxel_hash(neigh) & (table_size - 1)).to(torch.int64)


def voxel_nn(
    table: VoxelTable,
    query: torch.Tensor,
    voxel_size: float,
    max_distance: float,
    neighborhood: int = 27,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest stored point of each ``query (N, 3)`` closer than
    ``max_distance``, among the neighbour buckets of
    :func:`neighbor_bucket_hashes`. Returns ``(targets (N,3), normals (N,3),
    weights (N,))`` like :func:`associate`."""
    table_size, bucket_cap, _ = table.points.shape
    n = query.shape[0]
    h = neighbor_bucket_hashes(query, voxel_size, table_size, neighborhood)
    k = h.shape[1]
    cand = table.points[h].reshape(n, k * bucket_cap, 3)
    d2 = torch.sum((cand - query[:, None, :]) ** 2, dim=-1)
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, 1, best[:, None])[:, 0]
    target = torch.gather(cand, 1, best[:, None, None].expand(n, 1, 3))[:, 0]
    best_bucket = torch.gather(h, 1, (best // bucket_cap)[:, None])[:, 0]
    normal = table.normals[best_bucket, best % bucket_cap]
    ok = (best_d2 < max_distance * max_distance) & (torch.linalg.norm(normal, dim=-1) > 0.5)
    return target, normal, ok.to(query.dtype)


def gather_voxel_candidates(
    table: VoxelTable,
    query: torch.Tensor,
    voxel_size: float,
    neighborhood: int = 27,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's neighbour-bucket candidates, gathered once:
    ``(cand_points (N, k·cap, 3), cand_normals (N, k·cap, 3))``."""
    table_size, bucket_cap, _ = table.points.shape
    n = query.shape[0]
    h = neighbor_bucket_hashes(query, voxel_size, table_size, neighborhood)
    k = h.shape[1]
    cand_pts = table.points[h].reshape(n, k * bucket_cap, 3)
    cand_nrm = table.normals[h].reshape(n, k * bucket_cap, 3)
    return cand_pts, cand_nrm


def nn_from_candidates(
    cand_points: torch.Tensor,
    cand_normals: torch.Tensor,
    query: torch.Tensor,
    max_distance: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest cached candidate of each query; same contract as
    :func:`voxel_nn`."""
    n = query.shape[0]
    d2 = torch.sum((cand_points - query[:, None, :]) ** 2, dim=-1)
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, 1, best[:, None])[:, 0]
    idx = best[:, None, None].expand(n, 1, 3)
    target = torch.gather(cand_points, 1, idx)[:, 0]
    normal = torch.gather(cand_normals, 1, idx)[:, 0]
    ok = (best_d2 < max_distance * max_distance) & (torch.linalg.norm(normal, dim=-1) > 0.5)
    return target, normal, ok.to(query.dtype)
