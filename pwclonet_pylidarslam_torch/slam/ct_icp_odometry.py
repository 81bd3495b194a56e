"""Continuous-time (elastic) frame-to-model ICP odometry.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/ct_icp_odometry.py``.
Each scan carries two poses, at the begin and at the end of the sweep, and
every point is placed at the pose interpolated at its own timestamp, so the
motion de-skew is solved together with the registration (elastic ICP,
Dellenbach et al., ICRA 2022). The local map, its model map and the
projective association are those of :mod:`slam.icp_odometry`; the
Gauss-Newton step is over the 12 dof ``(xi_begin, xi_end)`` with the CT-ICP
soft priors (location and orientation consistency, constant velocity) as
extra rows of the 12×12 normal equations.

Where the reference branches on device data, this port decides as follows:

- the iteration loop (``lax.while_loop``) runs on the host and stops at
  convergence, as ``icp_odometry._register`` does: while the association
  gate is above its floor, convergence is false by definition and nothing
  is read; from the iteration whose gate reaches the floor on, the flag is
  read once an iteration (one host read, counted in ``StepStats``);
- the frame counter is a Python int beside the tensor state, so the frame-1
  repair of map slot 0 (``lax.cond``) and the frame-0 capture of the
  bootstrap scan (``where``) cost no read;
- the empty-map guard stays a tensor under ``torch.where``.

Products run in full fp32 whatever the caller set, as the reference runs
its einsums at ``precision=HIGHEST``: :func:`process_frame` turns cuBLAS's
and cuDNN's TF32 switches off for the step and restores them after.

As in the reference, a CT-ICP state has ``end_pose`` and no ``pose``, so the
pipeline's back-end resync leaves it as it is, and :class:`CTICPOdometry`
has no snapshot.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import optimization as opt, se3
from pwclonet_pylidarslam_torch.core.geometry import compute_normal_map, estimate_timestamps
from pwclonet_pylidarslam_torch.core.projection import (
    SphericalProjector,
    density_matched_projector,
    spherical_pixel_coords,
)
from pwclonet_pylidarslam_torch.core.rotation import hat, so3_log
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.slam import local_map as lm
from pwclonet_pylidarslam_torch.slam.icp_odometry import (
    StepStats,
    _fetch,
    _normalize_or_nan,
    full_fp32_products,
    stack_results,
)


@dataclasses.dataclass(frozen=True)
class CTICPConfig:
    """Continuous-time ICP settings; the fields and defaults of the
    reference's ``CTICPConfig``, whose comments give the reasons for each."""

    # None: the vertex-map resolution is matched to the scan density
    projector: Optional[SphericalProjector] = None
    num_points: int = 8192
    local_map_size: int = 20
    max_num_alignments: int = 15
    threshold_delta_pose: float = 1e-4
    threshold_trans: float = 0.1  # keyframe gate, meters
    threshold_rot: float = 0.3  # keyframe gate, degrees
    sigma: float = 0.1
    scheme: str = "huber"
    max_assoc_distance: float = 0.5
    initial_assoc_distance: float = 4.0
    normal_kernel_size: int = 5
    # soft priors, weighted by beta times the effective point evidence:
    # the begin pose at the previous end (location, orientation) and the
    # sweep screw at the previous one (constant velocity)
    beta_location_consistency: float = 0.003
    beta_orientation_consistency: float = 0.003
    beta_constant_velocity: float = 0.003
    # False: a rigid solve over xi_end only, the scan taken as instantaneous
    elastic: bool = True

    def __post_init__(self):
        if self.projector is None:
            object.__setattr__(self, "projector", density_matched_projector(self.num_points))


class CTOdometryState(NamedTuple):
    map: lm.LocalMapState
    end_pose: torch.Tensor  # (4, 4) world pose at the END of the last sweep
    begin_pose: torch.Tensor  # (4, 4) world pose at the BEGIN of the last sweep
    last_rel: torch.Tensor  # (4, 4) end_{t-1} -> end_t motion (velocity prior)
    last_kf_pose: torch.Tensor  # (4, 4)
    frame_idx: int  # frames processed, on the host
    # frame 0 enters the map un-deskewed; its raw scan and timestamps are
    # kept so that frame 1 re-deskews it with the solved velocity
    boot_scan: torch.Tensor  # (N, 3)
    boot_alphas: torch.Tensor  # (N,)


class CTFrameResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) absolute END pose of this frame
    begin_pose: torch.Tensor  # (4, 4) absolute BEGIN pose of this frame
    rel_pose: torch.Tensor  # (4, 4) end-to-end relative motion
    num_matches: torch.Tensor  # () weighted matches of the last iteration
    icp_cost: torch.Tensor  # () final weighted cost
    inserted_keyframe: torch.Tensor  # () bool


def init_state(config: CTICPConfig, dtype=torch.float32,
               device: Union[str, torch.device] = "cuda") -> CTOdometryState:
    dev = resolve_device(device)
    eye = torch.eye(4, dtype=dtype, device=dev)
    return CTOdometryState(
        map=lm.init_local_map(config.local_map_size, config.num_points, dtype, dev),
        end_pose=eye.clone(),
        begin_pose=eye.clone(),
        last_rel=eye.clone(),
        last_kf_pose=eye.clone(),
        frame_idx=0,
        boot_scan=torch.zeros((config.num_points, 3), dtype=dtype, device=dev),
        boot_alphas=torch.zeros((config.num_points,), dtype=dtype, device=dev),
    )


def _ct_warp(a_pose: torch.Tensor, b_pose: torch.Tensor, alphas: torch.Tensor,
             points: torch.Tensor) -> torch.Tensor:
    """Each point ``(N, 3)`` moved by the SE(3) geodesic between ``a_pose``
    (alpha 0) and ``b_pose`` (alpha 1) at its own ``alphas (N,)``."""
    tau = se3.log((se3.inverse(a_pose) @ b_pose)[None])[0]  # (6,)
    m = a_pose[None] @ se3.exp(alphas[:, None] * tau[None, :])  # (N, 4, 4)
    return torch.einsum("nij,nj->ni", m[:, :3, :3], points) + m[:, :3, 3]


def _prior_blocks(config: CTICPConfig, a_pose: torch.Tensor, b_pose: torch.Tensor,
                  anchor_t: torch.Tensor, anchor_r: torch.Tensor, tau_prior: torch.Tensor,
                  n_eff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The elastic priors' ``(12, 12)`` and ``(12,)`` terms of the normal
    equations: location and orientation consistency on the begin twist, and
    the constant-velocity row ``[-I6 | I6]`` coupling both twists."""
    dtype, dev = a_pose.dtype, a_pose.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    # location: d trans(exp(xi_a) A) / d xi_a = [I | -t_A x]
    j_lc = torch.cat([eye3, -hat(a_pose[:3, 3])], dim=-1)
    r_lc = a_pose[:3, 3] - anchor_t
    # orientation: log(R_A R_anchorᵀ), d / d xi_a ≈ [0 | I]
    j_oc = torch.cat([torch.zeros_like(eye3), eye3], dim=-1)
    r_oc = so3_log((a_pose[:3, :3] @ anchor_r.T)[None])[0]
    # constant velocity: log(A⁻¹B) ≈ the previous sweep's screw
    w_cv = config.beta_constant_velocity * n_eff
    r_cv = se3.log((se3.inverse(a_pose) @ b_pose)[None])[0] - tau_prior

    j_a = torch.cat([j_lc, j_oc], dim=0)  # (6, 6) with respect to xi_a
    wvec = torch.cat([(config.beta_location_consistency * n_eff).expand(3),
                      (config.beta_orientation_consistency * n_eff).expand(3)])
    r_a = torch.cat([r_lc, r_oc])
    wj_a = j_a * wvec[:, None]
    hcv = w_cv * torch.eye(6, dtype=dtype, device=dev)
    ha = torch.cat([
        torch.cat([wj_a.T @ j_a + hcv, -hcv], dim=1),
        torch.cat([-hcv, hcv], dim=1),
    ], dim=0)
    ga = torch.cat([wj_a.T @ r_a - w_cv * r_cv, w_cv * r_cv])
    return ha, ga


def _register_ct(
    config: CTICPConfig,
    model: torch.Tensor,
    points: torch.Tensor,
    alphas: torch.Tensor,
    a_init: torch.Tensor,
    mask: torch.Tensor,
    stats: Optional[StepStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterated association and continuous-time point-to-plane Gauss-Newton.

    ``points (N, 3)`` in the sensor frame of each point's own instant,
    ``alphas (N,)`` their sweep fractions; the model map lies in the
    predicted end frame. Solves for ``(A, B)``, which map sensor coordinates
    at alpha 0 and alpha 1 into the model frame, from ``A = a_init`` (the
    previous end) and ``B = I`` (the prediction). Returns ``(A, B,
    num_matches, cost)`` of the last iteration.
    """
    stats = stats if stats is not None else StepStats()
    dtype, dev = points.dtype, points.device
    f32 = np.float32 if dtype == torch.float32 else np.float64
    anchor_t = a_init[:3, 3]
    anchor_r = a_init[:3, :3]
    tau_prior = se3.log(se3.inverse(a_init)[None])[0]  # the previous sweep's screw
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    # the time weights that split each row between the two twists
    wa = (1.0 - alphas) if config.elastic else torch.zeros_like(alphas)
    wb = alphas if config.elastic else torch.ones_like(alphas)
    a_pose = a_init
    b_pose = torch.eye(4, dtype=dtype, device=dev)
    floor = f32(config.max_assoc_distance)
    num_matches = cost = None
    i = 0
    while i < config.max_num_alignments:
        if config.elastic:
            warped = _ct_warp(a_pose, b_pose, alphas, points)
        else:  # the scan taken as instantaneous
            warped = se3.transform(b_pose[None], points[None])[0]
        # the gate and the robust scale in the precision of the points, as
        # the reference computes them from its float32 iteration counter
        gate = max(f32(config.initial_assoc_distance) * f32(2.0) ** f32(-i), floor)
        target, normal, w_assoc = lm.associate(model, warped, config.projector, float(gate))
        w = w_assoc * mask
        sigma_i = max(f32(config.sigma), f32(0.5) * gate)

        # point-to-plane rows at the warped points (a left twist in the
        # model frame): j = [n, x × n], r = n·(x − q)
        res = torch.sum(normal * (warped - target), dim=-1)
        j6 = torch.cat([normal, torch.linalg.cross(warped, normal)], dim=-1)
        rw = opt.robust_weights(res[None], config.scheme, sigma_i)[0] * w
        j12 = torch.cat([j6 * wa[:, None], j6 * wb[:, None]], dim=-1)
        wj = j12 * rw[:, None]
        h = wj.T @ j12
        g = wj.T @ res
        n_eff = torch.clamp_min(torch.sum(rw), 1.0)
        if config.elastic:
            ha, ga = _prior_blocks(config, a_pose, b_pose, anchor_t, anchor_r, tau_prior, n_eff)
            h = h + ha
            g = g + ga
        else:  # rigid: the begin block held by identity rows
            h = h + torch.block_diag(n_eff * eye6, torch.zeros_like(eye6))
        dx = opt.damped_step(h[None], g[None], 1e-9)[0]
        a_pose = se3.exp(dx[:6]) @ a_pose
        b_pose = se3.exp(dx[6:]) @ b_pose
        num_matches = torch.sum(w)
        cost = torch.sum((res * rw) ** 2)
        i += 1
        stats.iterations += 1
        # convergence counts only once the gate has annealed to its floor
        if i < config.max_num_alignments and gate <= f32(config.max_assoc_distance * 1.001):
            if stats.read(torch.linalg.norm(dx) < config.threshold_delta_pose):
                break
    return a_pose, b_pose, num_matches, cost


def _point_normals(proj: SphericalProjector, points: torch.Tensor, valid: torch.Tensor,
                   ksize: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point normals from the scan's own vertex and normal maps (each
    point takes the normal at its pixel). Returns ``(normals (N, 3), ok (N,))``."""
    vmap = proj.build_projection_map(points[None])
    normal_map = compute_normal_map(vmap, ksize)[0]
    rows, cols, _depth = spherical_pixel_coords(
        points[None], proj.height, proj.width, proj.min_vertical_fov, proj.max_vertical_fov)
    r_i = torch.clamp(torch.round(rows[0]).to(torch.int64), 0, proj.height - 1)
    c_i = torch.clamp(torch.round(cols[0]).to(torch.int64), 0, proj.width - 1)
    pt_normals = normal_map[r_i, c_i]
    pt_ok = valid * (torch.linalg.norm(pt_normals, dim=-1) > 0.5)
    return pt_normals, pt_ok


def process_frame(
    config: CTICPConfig,
    state: CTOdometryState,
    points: torch.Tensor,
    timestamps: Optional[torch.Tensor] = None,
    stats: Optional[StepStats] = None,
) -> Tuple[CTOdometryState, CTFrameResult]:
    """One continuous-time odometry step on ``points (num_points, 3)``, the
    raw (possibly motion-distorted) scan with zero rows as padding, and
    ``timestamps (num_points,)``, the sweep fractions in [0, 1] (estimated
    from the azimuth when None). ``stats`` counts the step's iterations and
    host reads."""
    with full_fp32_products():
        return _process_frame(config, state, points, timestamps, stats or StepStats())


def _process_frame(config: CTICPConfig, state: CTOdometryState, points: torch.Tensor,
                   timestamps: Optional[torch.Tensor], stats: StepStats
                   ) -> Tuple[CTOdometryState, CTFrameResult]:
    proj = config.projector
    dtype, dev = points.dtype, points.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    finite = torch.all(torch.isfinite(points), dim=-1, keepdim=True)
    points = torch.where(finite, points, 0.0)
    valid = (torch.linalg.norm(points, dim=-1) > 1e-3).to(dtype)
    if timestamps is None:
        alphas = estimate_timestamps(points[None])[0]
    else:
        alphas = torch.clamp(timestamps.to(dtype), 0.0, 1.0)
    alphas = alphas * valid

    # the end pose advances by the last relative motion; the begin pose is
    # the previous end
    predicted_end = state.end_pose @ state.last_rel
    a_init = se3.inverse(state.last_rel)  # the previous end, in predicted-end coordinates
    model = lm.build_model_map(state.map, predicted_end, proj)
    a_pose, b_pose, num_matches, cost = _register_ct(
        config, model, points, alphas, a_init, valid, stats)

    new_end = _normalize_or_nan(predicted_end @ b_pose)
    new_begin = _normalize_or_nan(predicted_end @ a_pose)
    empty_map = torch.sum(state.map.valid) == 0
    new_end = torch.where(empty_map, state.end_pose, new_end)
    new_begin = torch.where(empty_map, state.end_pose, new_begin)
    rel = torch.where(empty_map, eye, se3.inverse(state.end_pose) @ new_end)

    # de-skew into the END frame with the end-to-end motion, which the
    # registration pins down (the sweep screw is weakly observable);
    # elastic=False keeps scans rigid
    deskewed = _ct_warp(se3.inverse(rel), eye, alphas, points) if config.elastic else points
    deskewed = deskewed * valid[:, None]

    kf_rel = se3.log((se3.inverse(state.last_kf_pose) @ new_end)[None])[0]
    trans_mag = torch.linalg.norm(kf_rel[:3])
    rot_mag_deg = torch.linalg.norm(kf_rel[3:]) * (180.0 / math.pi)
    do_insert = (trans_mag > config.threshold_trans) | (
        rot_mag_deg > config.threshold_rot) | empty_map

    pt_normals, pt_ok = _point_normals(proj, deskewed, valid, config.normal_kernel_size)
    new_map = lm.insert_keyframe(state.map, deskewed, pt_normals, pt_ok, new_end, do_insert)

    if config.elastic and state.frame_idx == 1:
        # bootstrap repair: frame 0 entered the map raw; re-deskew it with
        # the solved velocity and overwrite slot 0. Its end-of-sweep pose is
        # this frame's begin pose.
        d0 = _ct_warp(se3.inverse(rel), eye, state.boot_alphas, state.boot_scan)
        v0 = (torch.linalg.norm(state.boot_scan, dim=-1) > 1e-3).to(dtype)
        d0 = d0 * v0[:, None]
        n0, ok0 = _point_normals(proj, d0, v0, config.normal_kernel_size)
        new_map = new_map._replace(
            points=torch.cat([d0[None], new_map.points[1:]]),
            normals=torch.cat([n0[None], new_map.normals[1:]]),
            pt_valid=torch.cat([ok0[None].to(new_map.pt_valid.dtype), new_map.pt_valid[1:]]),
            poses=torch.cat([new_begin[None], new_map.poses[1:]]),
        )

    first = state.frame_idx == 0
    new_state = CTOdometryState(
        map=new_map,
        end_pose=new_end,
        begin_pose=new_begin,
        last_rel=rel,
        last_kf_pose=torch.where(do_insert, new_end, state.last_kf_pose),
        frame_idx=state.frame_idx + 1,
        boot_scan=points if first else state.boot_scan,
        boot_alphas=alphas if first else state.boot_alphas,
    )
    return new_state, CTFrameResult(
        pose=new_end, begin_pose=new_begin, rel_pose=rel, num_matches=num_matches,
        icp_cost=cost, inserted_keyframe=do_insert,
    )


def process_sequence(
    config: CTICPConfig,
    state: CTOdometryState,
    scans: torch.Tensor,
    timestamps: Optional[torch.Tensor] = None,
    stats: Optional[List[StepStats]] = None,
) -> Tuple[CTOdometryState, CTFrameResult]:
    """Run ``scans (T, N, 3)`` (and ``timestamps (T, N)``), on the device
    already, frame by frame. Returns the last state and the stacked
    per-frame results, on the device; ``stats``, a list, gets one
    :class:`StepStats` a frame."""
    results = []
    for t in range(scans.shape[0]):
        frame_stats = StepStats()
        ts = None if timestamps is None else timestamps[t]
        state, r = process_frame(config, state, scans[t], ts, frame_stats)
        results.append(r)
        if stats is not None:
            stats.append(frame_stats)
    return state, stack_results(results)


class CTICPOdometry:
    """Host-side odometry holding the device state, with the protocol of
    :class:`~pwclonet_pylidarslam_torch.slam.icp_odometry.ICPOdometry`, so
    it plugs into ``SLAM`` and ``SLAMRunner``. Runs on ``device``, CUDA
    unless the caller asks for the CPU::

        odo = CTICPOdometry(CTICPConfig(), device="cuda")
        odo.init()
        for scan, times in zip(scans, sweep_times):   # numpy (N, 3), (N,)
            pose = odo.process_next_frame(scan, times)

    ``results`` holds one :class:`CTFrameResult` of numpy values a frame;
    ``iterations`` and ``host_reads`` the Gauss-Newton iterations and host
    reads of each step.
    """

    def __init__(self, config: Optional[CTICPConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or CTICPConfig()
        self.device = resolve_device(device)
        self.state: Optional[CTOdometryState] = None
        self.results: list = []
        self.iterations: list = []
        self.host_reads: list = []

    def init(self):
        self.state = init_state(self.config, device=self.device)
        self.results, self.iterations, self.host_reads = [], [], []

    def _upload(self, x: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def process_next_frame(self, points: np.ndarray,
                           timestamps: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed one scan ``(N, 3)`` and its optional sweep fractions
        ``(N,)``; returns the absolute 4×4 end pose (numpy)."""
        pts, ts = fix_scan_size(points, timestamps, self.config.num_points)
        stats = StepStats()
        self.state, result = process_frame(
            self.config, self.state, self._upload(pts), self._upload(ts), stats)
        fetched = _fetch(stack_results([result]))
        self.results.append(CTFrameResult(*(x[0] for x in fetched)))
        self.iterations.append(stats.iterations)
        self.host_reads.append(stats.host_reads + 1)  # + the fetch
        return self.results[-1].pose

    def process_sequence(self, scans: np.ndarray,
                         timestamps: Optional[np.ndarray] = None) -> np.ndarray:
        """Process ``(T, N, 3)`` scans (and ``(T, N)`` sweep fractions):
        one upload, the steps, one fetch. Appends the per-frame results and
        returns the absolute end poses ``(T, 4, 4)``."""
        stats: List[StepStats] = []
        self.state, results = process_sequence(
            self.config, self.state, self._upload(scans), self._upload(timestamps), stats)
        fetched = _fetch(results)
        self.iterations += [st.iterations for st in stats]
        self.host_reads += [st.host_reads + (t == 0) for t, st in enumerate(stats)]  # + the fetch
        for t in range(scans.shape[0]):
            self.results.append(CTFrameResult(*(x[t] for x in fetched)))
        return fetched.pose

    def relative_poses(self) -> np.ndarray:
        return np.stack([np.asarray(r.rel_pose) for r in self.results])

    def absolute_poses(self) -> np.ndarray:
        return np.stack([np.asarray(r.pose) for r in self.results])


def fix_scan_size(points: np.ndarray, timestamps: Optional[np.ndarray], n: int
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Random-sample (seeded by the row count) or zero-pad a scan ``(M, 3)``
    and its timestamps ``(M,)`` to exactly ``n`` rows, as the reference's
    ``CTICPOdometry._fix_size``."""
    pts = points.astype(np.float32)
    ts = None if timestamps is None else timestamps.astype(np.float32)
    if pts.shape[0] == n:
        return pts, ts
    if pts.shape[0] > n:
        idx = np.random.default_rng(pts.shape[0]).choice(pts.shape[0], n, replace=False)
        return pts[idx], (None if ts is None else ts[idx])
    pad = n - pts.shape[0]
    pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
    if ts is not None:
        ts = np.concatenate([ts, np.zeros((pad,), np.float32)])
    return pts, ts
