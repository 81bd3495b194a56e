"""Loop closure: submap aggregation, BEV spectral detection, ICP refinement.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/loop_closure.py``:
frames are grid-sampled to a fixed size and aggregate into submaps of
``submap_size`` frames with ``overlap``; candidate submaps are gated by the
distance of their centres and their temporal id distance; detection is a
BEV elevation-image spectral registration (``core/registration.py``);
refinement is a point-to-point Gauss-Newton ICP whose nearest neighbours
come from the masked kNN kernel and the gather kernel; accepted matches
emit ``(frame_i, frame_j, Z_ij)`` constraints for the pose-graph back end.

Submap bookkeeping is host-side Python on numpy arrays, as in the reference
(so ``serialize`` files of either implementation ``load`` into the other);
the sampling, registration and refinement run on ``device``, CUDA unless
the caller asks for the CPU. The host decides on device data twice a
candidate (the registration's confidence, then the refined pose and its
RMSE, fetched together) and fetches each sampled frame and submap; every
such read is counted in :class:`LoopClosureStats`. Products run in full
fp32 (TF32 off, restored after), as the reference's refinement runs at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.core import optimization as opt, se3
from pwclonet_pylidarslam_torch.core.pointcloud import grid_sample_fixed
from pwclonet_pylidarslam_torch.core.registration import BEVConfig, planar_to_pose, register_bev
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.slam.icp_odometry import StepStats, full_fp32_products


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """The reference's ``LoopClosureConfig``, whose comments give the reasons."""

    submap_size: int = 50  # frames per submap
    overlap: int = 20  # overlapping frames between submaps
    max_num_candidates: int = 10
    max_distance: float = 100.0  # meters between submap centres
    min_id_distance: int = 200  # frames
    sample_voxel_size: float = 0.5  # grid sampling of each frame
    points_per_frame: int = 2048  # fixed-size per-frame sample
    submap_points: int = 16384  # fixed-size submap cloud
    bev: BEVConfig = BEVConfig()
    min_confidence: float = 2.0  # spectral registration acceptance
    icp_iterations: int = 8
    icp_max_distance: float = 2.0
    max_icp_rmse: float = 0.6  # accept threshold on refined alignment
    # sanity gate against the current trajectory estimate
    max_discrepancy_trans: float = 10.0  # meters
    max_discrepancy_rot: float = 0.5  # radians (~30 deg)


class Submap(NamedTuple):
    points: np.ndarray  # (P, 3) in the mid-frame coordinates
    mask: np.ndarray  # (P,)
    mid_frame_id: int
    mid_pose: np.ndarray  # (4, 4) absolute


class LoopConstraint(NamedTuple):
    frame_i: int
    frame_j: int
    relative_pose: np.ndarray  # pose of frame_j expressed in frame_i (Z_ij)
    confidence: float


class LoopClosureStats(StepStats):
    """What loop closure did on the host: frames, submaps, candidates
    registered, refinements run (the candidates that passed the confidence
    gate: 8 masked kNN and 8 gathers each at the default setting),
    constraints accepted, host reads, and the seconds of each submap's
    search (its build, registrations and refinements)."""

    def __init__(self):
        super().__init__()
        self.frames = 0
        self.submaps = 0
        self.candidates = 0
        self.refinements = 0
        self.accepted = 0
        self.submap_seconds: List[float] = []


def _refine_icp(
    config: LoopClosureConfig,
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    init: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point Gauss-Newton ICP refining ``init`` with ``tgt ≈ T·src``.

    Returns (pose, masked RMSE), on the device: no host read. Each of the
    ``icp_iterations`` runs one masked kNN (k=1, ``tgt_mask``) and one
    gather of the matched points.
    """
    pose = init
    rmse = torch.full((), float("inf"), dtype=src.dtype, device=src.device)
    for _ in range(config.icp_iterations):
        warped = se3.transform(pose[None], src[None])[0]
        d, idx = ops.knn(warped[None], tgt[None], 1, ref_mask=tgt_mask[None])
        nn = ops.gather_points(tgt[None], idx[..., 0])[0]
        dist = torch.sqrt(d[0, :, 0])
        w = src_mask * (dist < config.icp_max_distance)
        result = opt.solve_point_to_point(
            src[None], nn[None], mask=w[None], init_pose=pose[None],
            max_iters=1, norm_stop_criterion=0.0, scheme="huber", sigma=0.5,
        )
        pose = result.pose[0]
        rmse = torch.sqrt(torch.sum(w * dist**2) / torch.clamp_min(torch.sum(w), 1.0))
    return pose, rmse


class ElevationImageLoopClosure:
    """Host-side orchestrator of the device detection and refinement. Runs
    on ``device``, CUDA unless the caller asks for the CPU."""

    def __init__(self, config: Optional[LoopClosureConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or LoopClosureConfig()
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.submaps: List[Submap] = []
        self.frame_poses: List[np.ndarray] = []
        self._current_pts: List[np.ndarray] = []
        self._current_masks: List[np.ndarray] = []
        self._current_frame_ids: List[int] = []
        self.constraints: List[LoopConstraint] = []
        self.stats = LoopClosureStats()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def _grid_sample(self, points: np.ndarray, mask: np.ndarray, n: int):
        """Grid-sample on the device to ``n`` points; both back as numpy in
        one read."""
        sampled, smask = grid_sample_fixed(
            self._put(points), self.config.sample_voxel_size, n, self._put(mask))
        both = self.stats.fetch(torch.cat([sampled, smask[:, None]], dim=1))
        return both[:, :3].copy(), both[:, 3].copy()

    # -- submap construction ------------------------------------------------

    def process_next_frame(
        self, points: np.ndarray, absolute_pose: np.ndarray
    ) -> List[LoopConstraint]:
        """Feed one frame (sensor-frame points + current pose estimate).
        Returns any new loop constraints found this step."""
        cfg = self.config
        frame_id = len(self.frame_poses)
        self.frame_poses.append(np.asarray(absolute_pose, np.float64))
        self.stats.frames += 1

        points = np.asarray(points, np.float32)
        valid = (np.linalg.norm(points, axis=-1) > 1e-6).astype(np.float32)
        sampled, mask = self._grid_sample(points, valid, cfg.points_per_frame)
        self._current_pts.append(sampled)
        self._current_masks.append(mask)
        self._current_frame_ids.append(frame_id)

        new_constraints: List[LoopConstraint] = []
        if len(self._current_frame_ids) >= cfg.submap_size:
            t0 = time.perf_counter()
            with full_fp32_products():
                submap = self._finish_submap()
                new_constraints = self._search_loops(submap)
            self.stats.submap_seconds.append(time.perf_counter() - t0)
            self.submaps.append(submap)
            self.stats.submaps += 1
            # keep the overlap tail for the next submap
            keep = cfg.overlap
            self._current_pts = self._current_pts[-keep:]
            self._current_masks = self._current_masks[-keep:]
            self._current_frame_ids = self._current_frame_ids[-keep:]
        self.constraints.extend(new_constraints)
        return new_constraints

    def _finish_submap(self) -> Submap:
        cfg = self.config
        mid_idx = self._current_frame_ids[len(self._current_frame_ids) // 2]
        mid_pose = self.frame_poses[mid_idx]
        inv_mid = np.linalg.inv(mid_pose)
        pts_all, mask_all = [], []
        for pts, mask, fid in zip(
            self._current_pts, self._current_masks, self._current_frame_ids
        ):
            rel = inv_mid @ self.frame_poses[fid]
            hom = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], -1)
            pts_all.append((rel @ hom.T).T[:, :3].astype(np.float32))
            mask_all.append(mask)
        # grid-sample down to the fixed submap budget
        sampled, smask = self._grid_sample(
            np.concatenate(pts_all), np.concatenate(mask_all), cfg.submap_points)
        return Submap(points=sampled, mask=smask, mid_frame_id=mid_idx, mid_pose=mid_pose)

    # -- detection ----------------------------------------------------------

    def _candidates(self, submap: Submap) -> List[int]:
        cfg = self.config
        out = []
        for k, old in enumerate(self.submaps):
            if submap.mid_frame_id - old.mid_frame_id < cfg.min_id_distance:
                continue
            d = np.linalg.norm(submap.mid_pose[:3, 3] - old.mid_pose[:3, 3])
            if d > cfg.max_distance:
                continue
            out.append(k)
        # nearest first, cap the candidate count
        out.sort(
            key=lambda k: np.linalg.norm(
                submap.mid_pose[:3, 3] - self.submaps[k].mid_pose[:3, 3]
            )
        )
        return out[: cfg.max_num_candidates]

    def _search_loops(self, submap: Submap) -> List[LoopConstraint]:
        cfg = self.config
        found = []
        pb = self._put(submap.points)
        mb = self._put(submap.mask)
        for k in self._candidates(submap):
            old = self.submaps[k]
            pa = self._put(old.points)
            ma = self._put(old.mask)
            reg = register_bev(pa, ma, pb, mb, cfg.bev)
            self.stats.candidates += 1
            confidence = float(self.stats.fetch(reg.confidence))
            if confidence < cfg.min_confidence:
                continue
            init = planar_to_pose(reg, pa.dtype)
            pose, rmse = _refine_icp(cfg, pb, mb, pa, ma, init)
            self.stats.refinements += 1
            fetched = self.stats.fetch(torch.cat([rmse[None], pose.reshape(16)]))
            pose_np = fetched[1:].reshape(4, 4)
            if float(fetched[0]) > cfg.max_icp_rmse or not np.all(np.isfinite(pose_np)):
                continue
            # pose maps submap-b (current, frame j) coords → submap-a (frame i);
            # normalized on the host from the fetched float32 pose
            z_ij = se3.normalize(torch.from_numpy(pose_np)).numpy().astype(np.float64)
            # discrepancy gate vs the current trajectory estimate
            z_expected = np.linalg.inv(old.mid_pose) @ submap.mid_pose
            delta = se3.log(torch.from_numpy(
                (np.linalg.inv(z_expected) @ z_ij).astype(np.float32))[None])[0].numpy()
            if (
                np.linalg.norm(delta[:3]) > cfg.max_discrepancy_trans
                or np.linalg.norm(delta[3:]) > cfg.max_discrepancy_rot
            ):
                continue
            self.stats.accepted += 1
            found.append(
                LoopConstraint(
                    frame_i=old.mid_frame_id,
                    frame_j=submap.mid_frame_id,
                    relative_pose=z_ij,
                    confidence=confidence,
                )
            )
        return found

    # -- persistence: one .npz, in the reference's layout -------------------

    def serialize(self, path: str):
        """Save submaps, frame poses and constraints to one ``.npz``."""
        payload = {
            "frame_poses": np.stack(self.frame_poses) if self.frame_poses else np.zeros((0, 4, 4)),
            "n_submaps": np.asarray(len(self.submaps)),
            "n_constraints": np.asarray(len(self.constraints)),
        }
        for k, sm in enumerate(self.submaps):
            payload[f"submap_{k}_points"] = sm.points
            payload[f"submap_{k}_mask"] = sm.mask
            payload[f"submap_{k}_mid"] = np.asarray([sm.mid_frame_id])
            payload[f"submap_{k}_pose"] = sm.mid_pose
        for k, c in enumerate(self.constraints):
            payload[f"constraint_{k}"] = np.concatenate(
                [[c.frame_i, c.frame_j, c.confidence], c.relative_pose.reshape(-1)]
            )
        np.savez_compressed(path, **payload)

    def load(self, path: str):
        data = np.load(path)
        self.reset()
        self.frame_poses = [p for p in data["frame_poses"]]
        for k in range(int(data["n_submaps"])):
            self.submaps.append(
                Submap(
                    points=data[f"submap_{k}_points"],
                    mask=data[f"submap_{k}_mask"],
                    mid_frame_id=int(data[f"submap_{k}_mid"][0]),
                    mid_pose=data[f"submap_{k}_pose"],
                )
            )
        for k in range(int(data["n_constraints"])):
            row = data[f"constraint_{k}"]
            self.constraints.append(
                LoopConstraint(
                    frame_i=int(row[0]), frame_j=int(row[1]),
                    relative_pose=row[3:].reshape(4, 4), confidence=float(row[2]),
                )
            )

    # -- resync after a back-end optimization -------------------------------

    def update_positions(self, trajectory: np.ndarray):
        n = min(len(trajectory), len(self.frame_poses))
        for i in range(n):
            self.frame_poses[i] = np.asarray(trajectory[i], np.float64)
        for k, sm in enumerate(self.submaps):
            if sm.mid_frame_id < n:
                self.submaps[k] = sm._replace(mid_pose=self.frame_poses[sm.mid_frame_id])
