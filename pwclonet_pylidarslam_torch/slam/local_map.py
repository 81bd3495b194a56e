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

Every function also takes a leading sequence axis S on all of its tensors
(``BatchedICPOdometry``): each sequence is mapped, sorted and scattered on
its own row, so its result is the one it would get alone.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=32)
def batch_index(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The sequence index of every element of ``shape`` (``shape[0]`` = S),
    to index the sequence axis beside index tensors of that shape. Cached,
    so a Gauss-Newton iteration launches nothing to make it; whole, since
    CUDA's indexing copies an index it has to broadcast."""
    s = shape[0]
    return torch.arange(s, device=device).reshape((s,) + (1,) * (len(shape) - 1)).expand(
        shape).contiguous()


def _lead(*xs: torch.Tensor, rank: int):
    """``xs`` with a sequence axis of 1 in front where the first has only
    ``rank`` dims (views: no launch); and whether it was added."""
    if xs[0].dim() > rank:
        return xs, False
    return tuple(x.unsqueeze(0) for x in xs), True


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
    slot is selected on the device, with no host read. With a sequence
    axis, each sequence has its own ``do_insert`` and write pointer."""
    k = state.points.shape[-3]
    slot = state.next_slot.to(torch.int64)[..., None] % k
    write = (torch.arange(k, device=slot.device) == slot) & do_insert[..., None]  # (..., K)

    def mix(buf, new):
        sel = write.reshape(write.shape + (1,) * (buf.dim() - write.dim()))
        return torch.where(sel, new.to(buf.dtype).unsqueeze(write.dim() - 1), buf)

    return LocalMapState(
        points=mix(state.points, points),
        normals=mix(state.normals, normals),
        pt_valid=mix(state.pt_valid, pt_valid),
        poses=mix(state.poses, pose),
        valid=torch.where(write, torch.clamp_min(state.valid, 1.0), state.valid),
        next_slot=state.next_slot + do_insert.to(torch.int32),
    )


def _rotate(rot: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``rot (..., K, 3, 3)`` applied to ``vecs (..., K, P, 3)``, elementwise."""
    return torch.sum(rot[..., None, :, :] * vecs[..., :, None, :], dim=-1)


def flatten_map_points(
    state: LocalMapState, query_pose: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All stored keyframe points and normals brought into the query frame.
    Returns ``(points (..., K·P, 3), normals (..., K·P, 3), valid (..., K·P))``."""
    *lead, k, p, _ = state.points.shape
    rel = se3.inverse(query_pose)[..., None, :, :] @ state.poses
    pts_q = se3.transform(rel, state.points)
    nrm_q = _rotate(rel[..., :3, :3], state.normals)
    pt_ok = state.pt_valid * state.valid[..., None]
    return (pts_q.reshape(*lead, k * p, 3), nrm_q.reshape(*lead, k * p, 3),
            pt_ok.reshape(*lead, k * p))


def build_model_map(
    state: LocalMapState, query_pose: torch.Tensor, projector: SphericalProjector
) -> torch.Tensor:
    """Aggregate the stored keyframes into one model map ``(..., H, W, 6)``
    (xyz + normal) in the query frame; the nearest point wins a pixel."""
    flat_pts, flat_nrm, flat_valid = flatten_map_points(state, query_pose)
    (flat_pts, flat_nrm, flat_valid), single = _lead(flat_pts, flat_nrm, flat_valid, rank=2)
    rows, cols, depth = spherical_pixel_coords(
        flat_pts, projector.height, projector.width,
        projector.min_vertical_fov, projector.max_vertical_fov,
    )
    depth = torch.where(flat_valid > 0, depth, 0.0)
    chan = torch.cat([flat_pts, flat_nrm], dim=-1)
    out = zbuffer_scatter(chan, rows, cols, depth, projector.height, projector.width)
    return out[0] if single else out


def associate(
    model: torch.Tensor,
    points: torch.Tensor,
    projector: SphericalProjector,
    max_distance: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projective association of ``points (..., N, 3)`` against a model
    ``(..., H, W, 6)``: each point takes the model pixel it projects to;
    empty pixels and matches at ``max_distance`` or farther are masked out.
    Returns ``(targets (..., N,3), normals (..., N,3), weights (..., N))``."""
    (model, points), single = _lead(model, points, rank=3)
    rows, cols, depth = spherical_pixel_coords(
        points, projector.height, projector.width,
        projector.min_vertical_fov, projector.max_vertical_fov,
    )
    r_i = torch.clamp(torch.round(rows).to(torch.int64), 0, projector.height - 1)
    c_i = torch.clamp(torch.round(cols).to(torch.int64), 0, projector.width - 1)
    hit = model[batch_index(tuple(r_i.shape), model.device), r_i, c_i]
    target, normal = hit[..., :3], hit[..., 3:]
    dist = torch.linalg.norm(points - target, dim=-1)
    ok = (
        (depth > 0)
        & (torch.linalg.norm(target, dim=-1) > 0)
        & (torch.linalg.norm(normal, dim=-1) > 0.5)
        & (dist < max_distance)
    )
    out = (target, normal, ok.to(points.dtype))
    return tuple(x[0] for x in out) if single else out


# --- voxel-hash nearest-neighbour map ------------------------------------


class VoxelTable(NamedTuple):
    """Bucketed point store; empty slots hold the 1e9 sentinel point and a
    zero normal."""

    points: torch.Tensor  # ([S,] table_size, bucket_cap, 3)
    normals: torch.Tensor  # ([S,] table_size, bucket_cap, 3)


def _scatter_table(points, normals, order, dest, rows: int, bucket_cap: int) -> VoxelTable:
    """Write the sorted points ``(S, M, 3)`` to their slots; ``dest (S, M)``
    is unique in a row except for the spill slot ``rows·cap``, which is cut
    off."""
    s = points.shape[0]
    slots = rows * bucket_cap + 1
    table_pts = torch.full((s, slots, 3), 1e9, dtype=points.dtype, device=points.device)
    table_nrm = torch.zeros((s, slots, 3), dtype=normals.dtype, device=normals.device)
    seq = batch_index(tuple(order.shape), points.device)
    table_pts[seq, dest] = points[seq, order]
    table_nrm[seq, dest] = normals[seq, order]
    return VoxelTable(
        points=table_pts[:, :-1].reshape(s, rows, bucket_cap, 3),
        normals=table_nrm[:, :-1].reshape(s, rows, bucket_cap, 3),
    )


def _unlead(table: VoxelTable, single: bool) -> VoxelTable:
    return VoxelTable(table.points[0], table.normals[0]) if single else table


def scatter_buckets(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid_rows: torch.Tensor,
    row_id: torch.Tensor,
    rows: int,
    bucket_cap: int,
) -> VoxelTable:
    """Bucket ``points ([S,] M,3)`` by ``row_id ([S,] M)`` (rows where
    ``valid_rows`` is false are dropped) into a ``([S,] rows, bucket_cap, 3)``
    store: one stable sort a sequence, then one scatter. A bucket keeps its
    ``bucket_cap`` lowest-index points."""
    (points, normals, valid_rows, row_id), single = _lead(
        points, normals, valid_rows, row_id, rank=2)
    m = points.shape[1]
    h = torch.where(valid_rows, row_id.to(torch.int64), rows)
    h_sorted, order = torch.sort(h, dim=-1, stable=True)
    first_of_bucket = torch.searchsorted(h_sorted, h_sorted, side="left")
    slot = torch.arange(m, device=points.device) - first_of_bucket
    keep = (slot < bucket_cap) & (h_sorted < rows)
    dest = h_sorted * bucket_cap + torch.clamp(slot, 0, bucket_cap - 1)
    dest = torch.where(keep, dest, rows * bucket_cap)
    return _unlead(_scatter_table(points, normals, order, dest, rows, bucket_cap), single)


def build_voxel_table(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    table_size: int = 1 << 16,
    bucket_cap: int = 8,
) -> VoxelTable:
    """Bucket ``points ([S,] M, 3)`` by the spatial hash of their
    ``voxel_size`` cell; ``valid ([S,] M)`` 0/1 rows. Points past a
    bucket's ``bucket_cap`` are dropped."""
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
    order. With a sequence axis, each sequence sorts its own row of keys.
    """
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    (points, normals, valid), single = _lead(points, normals, valid, rank=2)
    row_bits = int(table_size - 1).bit_length()
    sub_bits = 31 - row_bits
    row = (voxel_hash(floor_voxels(points, voxel_size)) & (table_size - 1)).to(torch.int64)
    sub = voxel_hash(floor_voxels(points, sample_size)).to(torch.int64) & UINT32_MAX
    sub = sub & ((1 << sub_bits) - 1)
    key = torch.where(valid > 0, (row << sub_bits) | sub, UINT32_MAX)
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    ok_sorted = key_sorted != UINT32_MAX
    new_group = torch.ones_like(ok_sorted)
    new_group[:, 1:] = key_sorted[:, 1:] != key_sorted[:, :-1]
    first_keep = new_group & ok_sorted
    row_sorted = key_sorted >> sub_bits
    first_of_row = torch.searchsorted(row_sorted, row_sorted, side="left")
    keep_i = first_keep.to(torch.int64)
    kept_before = torch.cumsum(keep_i, -1) - keep_i
    slot = kept_before - torch.gather(kept_before, 1, first_of_row)
    keep = first_keep & (slot < bucket_cap)
    dest = row_sorted * bucket_cap + torch.clamp(slot, 0, bucket_cap - 1)
    dest = torch.where(keep, dest, table_size * bucket_cap)
    return _unlead(_scatter_table(points, normals, order, dest, table_size, bucket_cap), single)


def _octant_offsets(device) -> torch.Tensor:
    i = torch.arange(8, device=device)
    return torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], -1)


def _cube_offsets(device) -> torch.Tensor:
    i = torch.arange(27, device=device)
    return torch.stack([i // 9 - 1, (i // 3) % 3 - 1, i % 3 - 1], -1)


def neighbor_bucket_hashes(
    query: torch.Tensor, voxel_size: float, table_size: int, neighborhood: int
) -> torch.Tensor:
    """Table rows of each query's neighbour buckets ``(..., N, k)``.

    ``neighborhood=8``: the half-offset 2x2x2 cells of ``2·voxel_size``
    nearest to the query (build the table with that cell size); ``27``: the
    3x3x3 cells of ``voxel_size``. Offsets run x, then y, then z fastest.
    """
    if neighborhood == 8:
        t = query / (2.0 * voxel_size)
        c = torch.floor(t).to(torch.int32)
        shift = torch.where(t - c >= 0.5, 0, -1).to(torch.int32)
        neigh = (c + shift)[..., None, :] + _octant_offsets(query.device).to(torch.int32)
    else:
        vox_q = floor_voxels(query, voxel_size)
        neigh = vox_q[..., None, :] + _cube_offsets(query.device).to(torch.int32)
    return (voxel_hash(neigh) & (table_size - 1)).to(torch.int64)


def voxel_nn(
    table: VoxelTable,
    query: torch.Tensor,
    voxel_size: float,
    max_distance: float,
    neighborhood: int = 27,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest stored point of each ``query ([S,] N, 3)`` closer than
    ``max_distance``, among the neighbour buckets of
    :func:`neighbor_bucket_hashes` in its sequence's table. Returns
    ``(targets ([S,] N,3), normals ([S,] N,3), weights ([S,] N))`` like
    :func:`associate`."""
    (tp, tn, query), single = _lead(table.points, table.normals, query, rank=3)
    s, table_size, bucket_cap, _ = tp.shape
    n = query.shape[1]
    h = neighbor_bucket_hashes(query, voxel_size, table_size, neighborhood)
    k = h.shape[-1]
    cand = tp[batch_index(tuple(h.shape), tp.device), h].reshape(s, n, k * bucket_cap, 3)
    d2 = torch.sum((cand - query[..., None, :]) ** 2, dim=-1)
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, 2, best[..., None])[..., 0]
    target = torch.gather(cand, 2, best[..., None, None].expand(s, n, 1, 3))[..., 0, :]
    best_bucket = torch.gather(h, 2, (best // bucket_cap)[..., None])[..., 0]
    normal = tn[batch_index(tuple(best.shape), tn.device), best_bucket, best % bucket_cap]
    ok = (best_d2 < max_distance * max_distance) & (torch.linalg.norm(normal, dim=-1) > 0.5)
    out = (target, normal, ok.to(query.dtype))
    return tuple(x[0] for x in out) if single else out


def gather_voxel_candidates(
    table: VoxelTable,
    query: torch.Tensor,
    voxel_size: float,
    neighborhood: int = 27,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's neighbour-bucket candidates, gathered once:
    ``(cand_points ([S,] N, k·cap, 3), cand_normals ([S,] N, k·cap, 3))``."""
    (tp, tn, query), single = _lead(table.points, table.normals, query, rank=3)
    s, table_size, bucket_cap, _ = tp.shape
    n = query.shape[1]
    h = neighbor_bucket_hashes(query, voxel_size, table_size, neighborhood)
    k = h.shape[-1]
    seq = batch_index(tuple(h.shape), tp.device)
    cand_pts = tp[seq, h].reshape(s, n, k * bucket_cap, 3)
    cand_nrm = tn[seq, h].reshape(s, n, k * bucket_cap, 3)
    return (cand_pts[0], cand_nrm[0]) if single else (cand_pts, cand_nrm)


def nn_from_candidates(
    cand_points: torch.Tensor,
    cand_normals: torch.Tensor,
    query: torch.Tensor,
    max_distance: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest cached candidate of each query; same contract as
    :func:`voxel_nn`."""
    d2 = torch.sum((cand_points - query[..., None, :]) ** 2, dim=-1)
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, -1, best[..., None])[..., 0]
    idx = best[..., None, None].expand(best.shape + (1, 3))
    target = torch.gather(cand_points, -2, idx)[..., 0, :]
    normal = torch.gather(cand_normals, -2, idx)[..., 0, :]
    ok = (best_d2 < max_distance * max_distance) & (torch.linalg.norm(normal, dim=-1) > 0.5)
    return target, normal, ok.to(query.dtype)
