"""Frame-to-model ICP odometry, projective or voxel association.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/icp_odometry.py``.
One step per frame: constant-velocity prediction (optionally replaced by a
BEV spectral registration), the model map or voxel table of the local map,
iterated association and point-to-plane Gauss-Newton, then the
motion-gated keyframe insert. The state is a ``NamedTuple`` of tensors on
the device; the host reads back only what decides the control flow.

Where the reference branches on device data, this port decides as follows:

- the iteration loop (``lax.while_loop``) runs on the host and stops at
  convergence, so a frame runs exactly the reference's iterations. While
  the association gate is still annealing, convergence is false by
  definition and nothing is read; from the iteration whose gate reaches its
  floor on, the flag is read once an iteration (one host read);
- the candidate-cache refresh of the voxel mode (``lax.cond``) is read on
  the host: gathering the candidates on both sides would move 8192 × 512 × 3
  floats of points and as many of normals (50 MB each) every iteration. The
  flag of the next iteration is computed at the end of the current one and
  read together with its convergence flag, so a voxel iteration costs one
  read;
- ``reassociate_every`` counts host iterations: no read;
- the lazy voxel table (``voxel_rebuild_every > 1``) reads its refresh
  flag on the host once a frame, since building the table on both sides
  would cost what the cache saves (one sequence; a batch builds and
  selects);
- the lazy model map: with both thresholds 0 (the default) the map is
  stale on every frame that moved, so it is always built and the cached one
  is selected with ``torch.where`` where the reference would not rebuild
  (no read); with a threshold set, one sequence reads the flag once a
  frame, since skipping the build is the point of the setting.

The step takes a leading sequence axis S on every state leaf and on the
scans (:func:`process_frame_batched`, :class:`BatchedICPOdometry`): the
semantics of the reference's ``vmap`` over ``process_frame``. The loop runs
until every sequence has converged, a converged one frozen by
``torch.where``; both sides of a rebuild are computed and selected per
sequence where S > 1, with no host read; the host reads of a step do not
grow with S. :func:`process_frame` is that step at S = 1.

Products run in full fp32 whatever the caller set: the step turns cuBLAS's
and cuDNN's TF32 switches off and restores them after, as the reference
runs its step under ``jax.default_matmul_precision("highest")``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import optimization as opt, se3
from pwclonet_pylidarslam_torch.core.geometry import compute_normal_map
from pwclonet_pylidarslam_torch.core.pointcloud import grid_sample_mask
from pwclonet_pylidarslam_torch.core.projection import (
    SphericalProjector,
    density_matched_projector,
    spherical_pixel_coords,
    zbuffer_scatter,
)
from pwclonet_pylidarslam_torch.core.registration import BEVConfig, planar_to_pose, register_bev
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.slam import local_map as lm


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """ICP odometry settings; the fields and defaults of the reference's
    ``ICPConfig``, whose comments give the reasons for each."""

    # None: the vertex-map resolution is matched to the scan density
    # (core.projection.density_matched_projector)
    projector: Optional[SphericalProjector] = None
    num_points: int = 8192  # fixed scan size (pad/subsample on the host)
    local_map_size: int = 20
    max_num_alignments: int = 15
    # fewer weighted matches than this: the step is skipped
    min_matches: int = 12
    threshold_delta_pose: float = 1e-4
    threshold_trans: float = 0.1  # meters, keyframe insert
    threshold_rot: float = 0.3  # degrees, keyframe insert
    sigma: float = 0.1  # robust scale floor
    scheme: str = "huber"
    sigma_anneal: float = 0.5  # sigma_i = max(sigma, sigma_anneal * gate_i)
    # coarse-to-fine association gate: halves each iteration from the
    # initial distance down to the max distance
    max_assoc_distance: float = 0.5
    initial_assoc_distance: float = 4.0
    gn_iters_per_alignment: int = 1
    normal_kernel_size: int = 5
    # BEV bootstrap: replace the constant-velocity prior by a BEV spectral
    # registration of the two latest scans when they disagree
    bev_bootstrap: bool = False
    bev_yaw_threshold_deg: float = 1.5
    bev_trans_threshold: float = 0.4
    bev_min_confidence: float = 2.0
    map_stride: int = 1  # keyframes enter the map angularly downsampled
    transfer_dtype: str = "float32"  # float32 | int16 host-to-device scans
    transfer_scale: float = 0.005  # meters / LSB for int16 transfers
    # lazy model re-projection thresholds (0/0: rebuild every frame)
    model_rebuild_trans: float = 0.0  # meters
    model_rebuild_rot: float = 0.0  # degrees
    association: str = "projective"  # projective | voxel
    voxel_size: float = 1.5  # meters; also the NN search reach
    voxel_table_size: int = 1 << 14
    voxel_bucket_cap: int = 64
    voxel_sample_size: float = 0.45  # grid-sample the map before bucketing
    voxel_skip_latest_keyframe: bool = True
    voxel_neighborhood: int = 8  # 8 (half-offset octants) | 27
    voxel_candidate_cache: bool = True
    voxel_cache_margin: float = 0.25
    voxel_rebuild_every: int = 1
    voxel_fused_build: bool = False
    reassociate_every: int = 1
    # constant-velocity prior factor on the normal equations (0 = off)
    prior_sigma_trans: float = 0.0  # meters
    prior_sigma_rot_deg: float = 0.0  # degrees

    def __post_init__(self):
        if self.projector is None:
            object.__setattr__(self, "projector", density_matched_projector(self.num_points))


class OdometryState(NamedTuple):
    map: lm.LocalMapState
    pose: torch.Tensor  # (4, 4) absolute pose of the last processed frame
    last_rel: torch.Tensor  # (4, 4) last relative motion (constant velocity)
    last_kf_pose: torch.Tensor  # (4, 4) pose of the last inserted keyframe
    frame_idx: torch.Tensor  # () int32
    prev_scan: torch.Tensor  # (N, 3) previous scan (BEV bootstrap source)
    model: torch.Tensor  # (H, W, 6) cached model map
    model_pose: torch.Tensor  # (4, 4) frame the cached model/table was built in
    model_valid: torch.Tensor  # () float 0/1
    vox_pts: torch.Tensor  # (table_size, bucket_cap, 3) or (0, 0, 3)
    vox_nrm: torch.Tensor  # (table_size, bucket_cap, 3) or (0, 0, 3)


class FrameResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) absolute pose of this frame
    rel_pose: torch.Tensor  # (4, 4) motion from the previous frame
    num_matches: torch.Tensor  # () valid associations in the last iteration
    icp_cost: torch.Tensor  # () final weighted cost
    inserted_keyframe: torch.Tensor  # () bool


def state_leaves(state: OdometryState) -> List[torch.Tensor]:
    """The 16 tensors of a state in the reference's pytree flatten order:
    the six of the local map, then the ten other fields."""
    return list(state.map) + list(state[1:])


def state_from_leaves(leaves) -> OdometryState:
    """Inverse of :func:`state_leaves`."""
    leaves = list(leaves)
    return OdometryState(lm.LocalMapState(*leaves[:6]), *leaves[6:])


def _vox_cache_shape(config: ICPConfig) -> Tuple[int, int, int]:
    """The cached voxel table: zero-size unless the lazy rebuild is on."""
    if config.association == "voxel" and config.voxel_rebuild_every > 1:
        return (config.voxel_table_size, config.voxel_bucket_cap, 3)
    return (0, 0, 3)


def init_state(config: ICPConfig, dtype=torch.float32,
               device: Union[str, torch.device] = "cuda") -> OdometryState:
    dev = resolve_device(device)
    eye = torch.eye(4, dtype=dtype, device=dev)
    proj = config.projector
    return OdometryState(
        map=lm.init_local_map(
            config.local_map_size, config.num_points // config.map_stride, dtype, dev
        ),
        pose=eye.clone(),
        last_rel=eye.clone(),
        last_kf_pose=eye.clone(),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        prev_scan=torch.zeros((config.num_points, 3), dtype=dtype, device=dev),
        model=torch.zeros((proj.height, proj.width, 6), dtype=dtype, device=dev),
        model_pose=eye.clone(),
        model_valid=torch.zeros((), dtype=dtype, device=dev),
        vox_pts=torch.full(_vox_cache_shape(config), 1e9, dtype=dtype, device=dev),
        vox_nrm=torch.zeros(_vox_cache_shape(config), dtype=dtype, device=dev),
    )


@contextlib.contextmanager
def full_fp32_products():
    """Turn off TF32 in cuBLAS and cuDNN for the block; restore after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class StepStats:
    """What a step did on the host: Gauss-Newton iterations and host reads.
    ``sequence_iterations`` holds the iterations of each sequence of a
    batched step (its loop runs ``iterations``, the most of them)."""

    def __init__(self):
        self.iterations = 0
        self.sequence_iterations: List[int] = []
        self.host_reads = 0

    def read(self, t: torch.Tensor) -> list:
        self.host_reads += 1
        return t.tolist()

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """:meth:`read` as a numpy array."""
        self.host_reads += 1
        return t.cpu().numpy()


def _register(
    config: ICPConfig,
    assoc_fn,
    points: torch.Tensor,
    mask: torch.Tensor,
    init_delta: Optional[torch.Tensor] = None,
    assoc_cache_fns=None,
    stats: Optional[StepStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterated association + point-to-plane Gauss-Newton against the map,
    for S sequences at once: ``points (S, N, 3)``, ``mask (S, N)``.

    ``assoc_fn(warped (S,N,3), gate) -> (targets, normals, weights)``.
    Returns the correction ``delta (S,4,4)`` from scan to map-frame
    coordinates (the frame pose is ``model_pose @ delta``) and the
    (num_matches, cost) ``(S,)`` of each sequence's last iteration.
    ``assoc_cache_fns`` = ``(gather_fn(warped), from_cache_fn(cache, warped,
    gate, fresh))`` turns on the voxel candidate cache (S = 1 only: its
    refresh is read on the host).

    The loop runs until every sequence has converged, as the reference's
    ``while_loop`` under ``vmap``: a converged sequence is frozen (its
    ``delta``, matches and cost kept by ``torch.where``) while the others
    iterate. The host reads one flag vector an iteration from the gate's
    floor on, whatever S; the selects start only once a sequence has
    stopped, so a step at S = 1 runs none.
    """
    stats = stats if stats is not None else StepStats()
    s, dtype, dev = points.shape[0], points.dtype, points.device
    if assoc_cache_fns is not None and s > 1:
        raise ValueError("the voxel candidate cache runs one sequence at a time")
    f32 = np.float32 if dtype == torch.float32 else np.float64
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    delta = eye4.expand(s, 4, 4) if init_delta is None else init_delta
    w_prior = inv_init = None
    if config.prior_sigma_trans > 0 or config.prior_sigma_rot_deg > 0:
        wt = 1.0 / config.prior_sigma_trans**2 if config.prior_sigma_trans > 0 else 0.0
        wr = (1.0 / float(np.deg2rad(config.prior_sigma_rot_deg)) ** 2
              if config.prior_sigma_rot_deg > 0 else 0.0)
        w_prior = torch.cat([torch.full((3,), wt, dtype=dtype, device=dev),
                             torch.full((3,), wr, dtype=dtype, device=dev)])
        inv_init = eye4 if init_delta is None else se3.inverse(init_delta)
    margin = config.voxel_cache_margin * config.voxel_size
    floor = f32(config.max_assoc_distance)
    corr = None
    refresh = True
    warped = se3.transform(delta, points)
    num_matches = cost = None
    # which sequences still iterate: on the host (from the flags it reads)
    # and, once one has stopped, on the device for the selects
    running = [True] * s
    active = None
    sequence_iterations = [0] * s
    i = 0
    while i < config.max_num_alignments:
        # the gate and the robust scale in the precision of the points, as
        # the reference computes them from its float32 iteration counter
        gate = max(f32(config.initial_assoc_distance) * f32(2.0) ** f32(-i), floor)
        if assoc_cache_fns is not None:
            gather_fn, from_cache_fn = assoc_cache_fns
            if refresh:
                corr = tuple(gather_fn(warped)) + (warped,)
            target, normal, w_assoc = from_cache_fn(corr[:-1], warped, float(gate), refresh)
        elif config.reassociate_every > 1:
            if i % config.reassociate_every == 0:
                corr = assoc_fn(warped, float(gate))
            target, normal, w_assoc = corr
        else:
            target, normal, w_assoc = assoc_fn(warped, float(gate))
        w = w_assoc * mask
        sigma_i = max(f32(config.sigma), f32(config.sigma_anneal) * gate)
        res, jac = opt.point_to_plane_residual_jac(delta, points, target, normal, mask=w)
        rw = opt.robust_weights(res, config.scheme, sigma_i)
        wres = res * rw
        h, g = opt.normal_equations(jac * rw[..., None], wres)
        if w_prior is not None:
            xi = se3.log(delta @ inv_init)
            h = h + torch.diag(w_prior)
            g = g + w_prior * xi
        dx = opt.damped_step(h, g, 1e-9)
        new_matches = torch.sum(w, dim=-1)
        good = (new_matches >= config.min_matches) & torch.all(torch.isfinite(dx), dim=-1)
        dx = torch.where(good[:, None], dx, 0.0)
        new_delta = se3.exp(dx) @ delta
        new_cost = torch.sum(wres ** 2, dim=-1)
        if active is None:
            delta, num_matches, cost = new_delta, new_matches, new_cost
        else:
            delta = torch.where(active[:, None, None], new_delta, delta)
            num_matches = torch.where(active, new_matches, num_matches)
            cost = torch.where(active, new_cost, cost)
        i += 1
        stats.iterations += 1
        sequence_iterations = [n + r for n, r in zip(sequence_iterations, running)]
        if i >= config.max_num_alignments:
            break
        # convergence counts only once the gate has annealed to its floor
        gate_done = bool(gate <= f32(config.max_assoc_distance * 1.001))
        warped = se3.transform(delta, points)
        flags = []
        if gate_done:
            converged = torch.linalg.norm(dx, dim=-1) < config.threshold_delta_pose
            flags.append(converged)
        if assoc_cache_fns is not None:
            moved = torch.amax(torch.sum((warped - corr[-1]) ** 2, dim=-1), dim=-1)
            flags.append(moved > margin * margin)
        if not flags:
            continue
        values = stats.read(flags[0] if len(flags) == 1 else torch.cat(flags))
        if assoc_cache_fns is not None:
            refresh = bool(values[-1])
        if gate_done:
            running = [r and not c for r, c in zip(running, values[:s])]
            if not any(running):
                break
            if not all(running):
                active = ~converged if active is None else active & ~converged
    stats.sequence_iterations = sequence_iterations
    return delta, num_matches, cost


def _normalize_or_nan(pose: torch.Tensor) -> torch.Tensor:
    """``se3.normalize`` of a finite pose ``(..., 4, 4)``, NaN otherwise:
    the SVD is only given finite input, and a blown-up pose stays
    non-finite for the guard that replaces it by the prediction."""
    finite = _all_finite(pose)[..., None, None]
    safe = torch.where(finite, pose, torch.eye(4, dtype=pose.dtype, device=pose.device))
    return torch.where(finite, se3.normalize(safe), math.nan)


def _all_finite(pose: torch.Tensor) -> torch.Tensor:
    """Whether each ``(4, 4)`` of ``pose (..., 4, 4)`` is finite."""
    return torch.all(torch.isfinite(pose).flatten(-2), dim=-1)


def _bev_prior(config: ICPConfig, state: OdometryState, points, valid, dtype):
    """The reference's BEV bootstrap: the BEV registration of the previous
    scan against this one replaces the constant-velocity prior where they
    disagree by more than the thresholds and the registration is confident
    (each sequence on its own)."""
    prev_valid = (torch.linalg.norm(state.prev_scan, dim=-1) > 1e-3).to(dtype)
    reg = register_bev(state.prev_scan, prev_valid, points, valid,
                       BEVConfig(pixel_size=0.4, image_size=256))
    rel_bev = planar_to_pose(reg, dtype)
    yaw_cv = torch.atan2(state.last_rel[..., 1, 0], state.last_rel[..., 0, 0])
    dyaw = torch.abs(
        torch.remainder(reg.yaw - yaw_cv + math.pi, 2.0 * math.pi) - math.pi
    ) * (180.0 / math.pi)
    dtrans = torch.linalg.norm(rel_bev[..., :2, 3] - state.last_rel[..., :2, 3], dim=-1)
    use_bev = (
        ((dyaw > config.bev_yaw_threshold_deg) | (dtrans > config.bev_trans_threshold))
        & (reg.confidence > config.bev_min_confidence)
        & (state.frame_idx > 0)
    )
    return torch.where(use_bev[..., None, None], rel_bev, state.last_rel)


def frame_voxel_table(config: ICPConfig, map_state: lm.LocalMapState,
                      predicted: torch.Tensor) -> lm.VoxelTable:
    """The voxel table of a frame: the stored keyframes in the predicted
    frame, less the latest keyframe once the map holds two, grid-sampled,
    bucketed by cells of ``voxel_size`` (``2·voxel_size`` for the octant
    neighbourhood). Takes a leading sequence axis."""
    cell = config.voxel_size * (2.0 if config.voxel_neighborhood == 8 else 1.0)
    flat_pts, flat_nrm, flat_ok = lm.flatten_map_points(map_state, predicted)
    if config.voxel_skip_latest_keyframe:
        k, p = map_state.points.shape[-3:-1]
        latest = (map_state.next_slot.to(torch.int64)[..., None] - 1) % k
        slot_ids = torch.arange(k, device=flat_ok.device).repeat_interleave(p)
        # a 1-keyframe map is used
        multi = (torch.sum(map_state.valid, dim=-1) > 1.5)[..., None]
        flat_ok = torch.where(multi & (slot_ids == latest), 0.0, flat_ok)
    if config.voxel_fused_build and config.voxel_sample_size > 0:
        return lm.build_voxel_table_fused(
            flat_pts, flat_nrm, flat_ok, cell, config.voxel_sample_size,
            config.voxel_table_size, config.voxel_bucket_cap,
        )
    if config.voxel_sample_size > 0:
        keep = grid_sample_mask(flat_pts, config.voxel_sample_size, valid=flat_ok)
        flat_ok = flat_ok * keep.to(flat_ok.dtype)
    return lm.build_voxel_table(
        flat_pts, flat_nrm, flat_ok, cell, config.voxel_table_size, config.voxel_bucket_cap,
    )


def process_frame(
    config: ICPConfig, state: OdometryState, points: torch.Tensor,
    stats: Optional[StepStats] = None,
) -> Tuple[OdometryState, FrameResult]:
    """One odometry step on ``points (num_points, 3)``, zero rows = padding.
    ``stats`` (a :class:`StepStats`) counts the step's iterations and host
    reads. The batched step at S = 1 (views in and out: no launch)."""
    new_state, result = process_frame_batched(
        config, state_from_leaves(x[None] for x in state_leaves(state)), points[None], stats)
    return (state_from_leaves(x[0] for x in state_leaves(new_state)),
            FrameResult(*(x[0] for x in result)))


def process_frame_batched(
    config: ICPConfig, state: OdometryState, points: torch.Tensor,
    stats: Optional[StepStats] = None,
) -> Tuple[OdometryState, FrameResult]:
    """One odometry step of S independent sequences: every state leaf and
    ``points (S, num_points, 3)`` carry a leading sequence axis, as the
    reference's ``vmap`` over ``process_frame``. Each sequence's result is
    the one its own step gives; the host reads of the step do not grow
    with S."""
    with full_fp32_products():
        return _process_frame(config, state, points, stats or StepStats())


def _process_frame(config: ICPConfig, state: OdometryState, points: torch.Tensor,
                   stats: StepStats) -> Tuple[OdometryState, FrameResult]:
    proj = config.projector
    s, dtype, dev = points.shape[0], points.dtype, points.device
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    finite = torch.all(torch.isfinite(points), dim=-1, keepdim=True)
    points = torch.where(finite, points, 0.0)
    valid = (torch.linalg.norm(points, dim=-1) > 1e-3).to(dtype)

    rel_prior = state.last_rel
    if config.bev_bootstrap:
        rel_prior = _bev_prior(config, state, points, valid, dtype)
    predicted = state.pose @ rel_prior
    empty_map = torch.sum(state.map.valid, dim=-1) == 0
    new_valid = torch.where(empty_map, 0.0, 1.0).to(dtype)

    def select(cond, new, old):
        return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - 1)), new, old)

    table = None
    if config.association == "voxel":
        if config.voxel_rebuild_every > 1:
            refresh = (state.model_valid == 0) | (
                torch.remainder(state.frame_idx, config.voxel_rebuild_every) == 0)
            # one sequence reads its flag and skips the build; several build
            # and select, as the reference's lax.cond under vmap does
            if s == 1 and not stats.read(refresh)[0]:
                table = lm.VoxelTable(state.vox_pts, state.vox_nrm)
                table_pose, table_valid = state.model_pose, state.model_valid
            else:
                built = frame_voxel_table(config, state.map, predicted)
                table = lm.VoxelTable(select(refresh, built.points, state.vox_pts),
                                      select(refresh, built.normals, state.vox_nrm))
                table_pose = select(refresh, predicted, state.model_pose)
                table_valid = torch.where(refresh, new_valid, state.model_valid)
        else:
            table = frame_voxel_table(config, state.map, predicted)
            table_pose, table_valid = predicted, new_valid

        assoc_cache_fns = None
        if config.voxel_candidate_cache:
            # a stale cache is complete only out to (1 - margin)·voxel_size
            stale_reach = (1.0 - config.voxel_cache_margin) * config.voxel_size

            def from_cache(cache, warped, gate, fresh):
                reach = float(np.float32(min(gate, config.voxel_size if fresh else stale_reach)))
                return lm.nn_from_candidates(cache[0], cache[1], warped, reach)

            assoc_cache_fns = (
                lambda warped: lm.gather_voxel_candidates(
                    table, warped, config.voxel_size, neighborhood=config.voxel_neighborhood),
                from_cache,
            )

        def assoc_fn(warped, gate):
            reach = float(np.float32(min(gate, config.voxel_size)))
            return lm.voxel_nn(table, warped, config.voxel_size, reach,
                               neighborhood=config.voxel_neighborhood)

        model, model_pose, model_valid = state.model, table_pose, table_valid
        init_delta = None if config.voxel_rebuild_every <= 1 else (
            se3.inverse(table_pose) @ predicted)
        delta, num_matches, cost = _register(
            config, assoc_fn, points, valid, init_delta, assoc_cache_fns, stats)
        new_pose = _normalize_or_nan(table_pose @ delta)
    else:
        stale_tw = se3.log(se3.inverse(state.model_pose) @ predicted)
        stale = (torch.linalg.norm(stale_tw[..., :3], dim=-1) > config.model_rebuild_trans) | (
            torch.linalg.norm(stale_tw[..., 3:], dim=-1) * (180.0 / math.pi)
            > config.model_rebuild_rot)
        rebuild = stale | (state.model_valid == 0)
        lazy = config.model_rebuild_trans != 0 or config.model_rebuild_rot != 0
        # with both thresholds 0 every frame that moved is stale: build and
        # select, no read. One sequence with a threshold set reads its flag
        # to skip the build; several build and select.
        if lazy and s == 1 and not stats.read(rebuild)[0]:
            model, model_pose = state.model, state.model_pose
        else:
            built = lm.build_model_map(state.map, predicted, proj)
            model = select(rebuild, built, state.model)
            model_pose = select(rebuild, predicted, state.model_pose)
        model_valid = torch.where(rebuild, new_valid, state.model_valid)
        init_delta = se3.inverse(model_pose) @ predicted

        def assoc_fn(warped, gate):
            return lm.associate(model, warped, proj, gate)

        delta, num_matches, cost = _register(
            config, assoc_fn, points, valid, init_delta, stats=stats)
        new_pose = _normalize_or_nan(model_pose @ delta)

    new_pose = select(_all_finite(new_pose), new_pose, predicted)
    new_pose = select(empty_map, state.pose, new_pose)
    rel = select(empty_map, eye4.expand(s, 4, 4), se3.inverse(state.pose) @ new_pose)

    kf_rel = se3.log(se3.inverse(state.last_kf_pose) @ new_pose)
    trans_mag = torch.linalg.norm(kf_rel[..., :3], dim=-1)
    rot_mag_deg = torch.linalg.norm(kf_rel[..., 3:], dim=-1) * (180.0 / math.pi)
    do_insert = (trans_mag > config.threshold_trans) | (
        rot_mag_deg > config.threshold_rot) | empty_map

    # per-point normals: the scan's vertex and normal maps, then each
    # point's normal at its pixel (points that lost the z-buffer take the
    # winner's normal)
    rows, cols, depth = spherical_pixel_coords(
        points, proj.height, proj.width, proj.min_vertical_fov, proj.max_vertical_fov)
    vmap = zbuffer_scatter(points, rows, cols, depth, proj.height, proj.width)
    normal_map = compute_normal_map(vmap, config.normal_kernel_size)
    r_i = torch.clamp(torch.round(rows).to(torch.int64), 0, proj.height - 1)
    c_i = torch.clamp(torch.round(cols).to(torch.int64), 0, proj.width - 1)
    pt_normals = normal_map[lm.batch_index(tuple(r_i.shape), dev), r_i, c_i]
    pt_ok = valid * (torch.linalg.norm(pt_normals, dim=-1) > 0.5)
    st = config.map_stride
    new_map = lm.insert_keyframe(
        state.map, points[:, ::st], pt_normals[:, ::st], pt_ok[:, ::st], new_pose, do_insert)

    lazy_vox = config.association == "voxel" and config.voxel_rebuild_every > 1
    new_state = OdometryState(
        map=new_map,
        pose=new_pose,
        last_rel=rel,
        last_kf_pose=select(do_insert, new_pose, state.last_kf_pose),
        frame_idx=state.frame_idx + 1,
        prev_scan=points,
        model=model,
        model_pose=model_pose,
        model_valid=model_valid,
        vox_pts=table.points if lazy_vox else state.vox_pts,
        vox_nrm=table.normals if lazy_vox else state.vox_nrm,
    )
    return new_state, FrameResult(
        pose=new_pose, rel_pose=rel, num_matches=num_matches, icp_cost=cost,
        inserted_keyframe=do_insert,
    )


def stack_results(results: list):
    """Per-frame results (``FrameResult`` or another NamedTuple of tensors)
    stacked along a new leading axis."""
    return type(results[0])(*(torch.stack(list(xs)) for xs in zip(*results)))


def process_sequence(
    config: ICPConfig, state: OdometryState, scans: torch.Tensor,
    stats: Optional[List[StepStats]] = None,
) -> Tuple[OdometryState, FrameResult]:
    """Run ``scans (T, N, 3)`` (on the device already) frame by frame.
    Returns the last state and the stacked per-frame results, on the
    device. No host read happens between frames beyond those of the steps;
    ``stats``, a list, gets one :class:`StepStats` a frame."""
    results = []
    for t in range(scans.shape[0]):
        frame_stats = StepStats()
        state, r = process_frame(config, state, scans[t], frame_stats)
        results.append(r)
        if stats is not None:
            stats.append(frame_stats)
    return state, stack_results(results)


def _fetch(results):
    """Stacked results (a NamedTuple of ``(T, ...)`` tensors) to numpy in
    one device-to-host copy; bool fields come back as bool."""
    t, dtype = results[0].shape[0], results[0].dtype
    flat = torch.cat([x.reshape(t, -1).to(dtype) for x in results], dim=1).cpu().numpy()
    out, col = [], 0
    for x in results:
        n = x[0].numel()
        v = flat[:, col:col + n].reshape((t,) + tuple(x.shape[1:]))
        out.append(v > 0 if x.dtype == torch.bool else v)
        col += n
    return type(results)(*out)


class ICPOdometry:
    """Host-side driver holding the device state. Runs on ``device``, CUDA
    unless the caller asks for the CPU::

        odo = ICPOdometry(ICPConfig(), device="cuda")
        odo.init()
        for scan in scans:                # (N, 3) numpy, zero rows = padding
            pose = odo.process_next_frame(scan)

    ``results`` holds one :class:`FrameResult` of numpy values a frame;
    ``iterations`` and ``host_reads`` the Gauss-Newton iterations and host
    reads of each step.
    """

    def __init__(self, config: Optional[ICPConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or ICPConfig()
        self.device = resolve_device(device)
        self.state: Optional[OdometryState] = None
        self.results: list = []
        self.iterations: list = []
        self.host_reads: list = []

    def init(self):
        self.state = init_state(self.config, device=self.device)
        self.results, self.iterations, self.host_reads = [], [], []

    def _fix_size(self, points: np.ndarray) -> np.ndarray:
        # per-frame seed: equal-sized scans must not share one row subset
        return fix_scan_size(points, self.config.num_points, seed=len(self.results))

    def _quant(self, pts: np.ndarray) -> np.ndarray:
        return quantize_scans(self.config, pts)

    def _upload(self, pts: np.ndarray) -> torch.Tensor:
        return dequantize_scans(self.config, torch.from_numpy(np.ascontiguousarray(pts)).to(
            self.device))

    def process_next_frame(self, points: np.ndarray) -> np.ndarray:
        """Feed one scan ``(N, 3)``; returns the absolute 4×4 pose (numpy)."""
        pts = self._upload(self._quant(self._fix_size(points)))
        stats = StepStats()
        self.state, result = process_frame(self.config, self.state, pts, stats)
        fetched = _fetch(stack_results([result]))
        self.results.append(FrameResult(*(x[0] for x in fetched)))
        self.iterations.append(stats.iterations)
        self.host_reads.append(stats.host_reads + 1)  # + the fetch
        return self.results[-1].pose

    def process_sequence(self, scans: np.ndarray) -> np.ndarray:
        """Process ``(T, N, 3)`` scans: one upload, the steps, one fetch.
        Appends the per-frame results and returns absolute poses ``(T,4,4)``."""
        stats: List[StepStats] = []
        self.state, results = process_sequence(
            self.config, self.state, self._upload(self._quant(scans)), stats)
        fetched = _fetch(results)
        self.iterations += [st.iterations for st in stats]
        self.host_reads += [st.host_reads + (t == 0) for t, st in enumerate(stats)]  # + the fetch
        for t in range(scans.shape[0]):
            self.results.append(FrameResult(*(x[t] for x in fetched)))
        return fetched.pose

    def relative_poses(self) -> np.ndarray:
        return np.stack([np.asarray(r.rel_pose) for r in self.results])

    def absolute_poses(self) -> np.ndarray:
        return np.stack([np.asarray(r.pose) for r in self.results])

    # --- state snapshots, in the reference's ``.npz`` layout: ``state_0``
    # to ``state_15`` in OdometryState's flatten order, and ``result_*``
    # stacked per FrameResult field. A snapshot of either implementation
    # restores into the other.

    def snapshot(self, path: str) -> None:
        """Write the device state and the accumulated results to one ``.npz``."""
        assert self.state is not None, "init() first"
        payload = {f"state_{i}": x.cpu().numpy() for i, x in enumerate(state_leaves(self.state))}
        if self.results:
            for field in FrameResult._fields:
                payload[f"result_{field}"] = np.stack(
                    [np.asarray(getattr(r, field)) for r in self.results])
        np.savez_compressed(path, **payload)

    def restore(self, path: str) -> None:
        """Load a snapshot written by :meth:`snapshot` (of this port or of
        the reference) onto this driver's device."""
        data = np.load(path)
        n = len(lm.LocalMapState._fields) + len(OdometryState._fields) - 1
        self.state = state_from_leaves(
            torch.from_numpy(np.array(data[f"state_{i}"])).to(self.device) for i in range(n))
        self.results = []
        if "result_pose" in data:
            for i in range(data["result_pose"].shape[0]):
                self.results.append(FrameResult(
                    **{f: np.asarray(data[f"result_{f}"][i]) for f in FrameResult._fields}))
        self.iterations, self.host_reads = [], []


def fix_scan_size(points: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Random-sample or zero-pad a scan ``(M, 3)`` to exactly ``n`` rows,
    deterministic in ``(M, seed)``."""
    if points.shape[0] == n:
        return points.astype(np.float32)
    if points.shape[0] > n:
        idx = np.random.default_rng((points.shape[0], seed)).choice(
            points.shape[0], n, replace=False)
        return points[idx].astype(np.float32)
    pad = np.zeros((n - points.shape[0], 3), np.float32)
    return np.concatenate([points.astype(np.float32), pad])


def quantize_scans(config: ICPConfig, pts: np.ndarray) -> np.ndarray:
    """Host-side scan quantization for the transfer (int16 at
    ``transfer_scale``). Out-of-range returns become padding, not clamped."""
    if config.transfer_dtype == "int16":
        s = config.transfer_scale
        q = np.round(pts / s)
        in_range = np.all(np.abs(q) <= 32767, axis=-1, keepdims=True)
        return np.where(in_range, q, 0.0).astype(np.int16)
    return pts.astype(np.float32)


def dequantize_scans(config: ICPConfig, pts: torch.Tensor) -> torch.Tensor:
    """Device-side dequantization of int16-transferred scans."""
    if config.transfer_dtype == "int16":
        return pts.to(torch.float32) * config.transfer_scale
    return pts


def init_states(config: ICPConfig, n_sequences: int, dtype=torch.float32,
                device: Union[str, torch.device] = "cuda") -> OdometryState:
    """:func:`init_state` of ``n_sequences`` sequences: every leaf with a
    leading sequence axis."""
    one = init_state(config, dtype, device)
    return state_from_leaves(
        x.expand((n_sequences,) + tuple(x.shape)).clone() for x in state_leaves(one))


class BatchedICPOdometry:
    """S independent sequences advance together, one batched step a frame
    (:func:`process_frame_batched`): the counterpart of the reference's
    ``vmap`` over ``process_sequence``. Runs on ``device``, CUDA unless the
    caller asks for the CPU::

        odo = BatchedICPOdometry(ICPConfig(), device="cuda")
        odo.init(n_sequences=11)
        poses = odo.process_chunk(scans)   # (S, T, N, 3) -> (S, T, 4, 4)

    The voxel candidate cache is turned off, as the reference turns it off
    under ``vmap`` (its refresh would gather for every sequence anyway).
    ``iterations`` holds, a frame, the Gauss-Newton iterations of each
    sequence; ``host_reads`` the host reads of each batched step.
    """

    def __init__(self, config: Optional[ICPConfig] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the sequence axis sharded over devices is parallel/, ROADMAP Queue A 9")
        config = config or ICPConfig()
        if config.association == "voxel" and config.voxel_candidate_cache:
            config = dataclasses.replace(config, voxel_candidate_cache=False)
        self.config = config
        self.device = resolve_device(device)
        self.states: Optional[OdometryState] = None
        self.iterations: List[List[int]] = []
        self.host_reads: List[int] = []
        self._pose_chunks: list = []

    def init(self, n_sequences: int):
        self.states = init_states(self.config, n_sequences, device=self.device)
        self.iterations, self.host_reads, self._pose_chunks = [], [], []

    def process_chunk(self, scans: np.ndarray) -> np.ndarray:
        """``scans (S, T, N, 3)`` → absolute poses ``(S, T, 4, 4)`` (numpy):
        one upload, T batched steps, one fetch."""
        assert self.states is not None, "init() first"
        q = torch.from_numpy(np.ascontiguousarray(quantize_scans(self.config, scans)))
        frames = dequantize_scans(self.config, q.to(self.device)).transpose(0, 1).contiguous()
        poses = []
        for t in range(frames.shape[0]):
            stats = StepStats()
            self.states, result = process_frame_batched(self.config, self.states, frames[t],
                                                        stats)
            poses.append(result.pose)
            self.iterations.append(stats.sequence_iterations)
            self.host_reads.append(stats.host_reads + (t == 0))  # + the fetch
        out = torch.stack(poses, dim=1).cpu().numpy()
        self._pose_chunks.append(out)
        return out

    def absolute_poses(self) -> np.ndarray:
        """All processed frames so far: ``(S, T_total, 4, 4)``."""
        return np.concatenate(self._pose_chunks, axis=1)
