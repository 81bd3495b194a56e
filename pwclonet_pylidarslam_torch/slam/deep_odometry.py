"""Deep LiDAR odometry (inference) in PyTorch: PWCLO-Net and PoseResNet.

Counterpart of ``PWCLONetOdometry`` and ``PoseNetOdometry`` in
``pwclonet_pylidarslam_tpu/slam/deep_odometry.py``: prepare each scan (a
fixed point count for PWCLO-Net, a vertex map for PoseResNet), run the
network on each consecutive frame pair on the device, and chain the
relative poses on the host in float64.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation.metrics import compute_relative_poses
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig, load_flax_variables
from pwclonet_pylidarslam_torch.models.posenet import PoseResNet, PoseResNetConfig, conv_precision


def _load_variables(model: torch.nn.Module, variables, device: torch.device) -> None:
    """Load a checkpoint of the port's trainer (its path, or the loaded dict
    with the network's state dict under ``"model"``) or a Flax tree
    ``{"params", "batch_stats"}`` of numpy arrays into ``model``; None keeps
    the seeded init."""
    if isinstance(variables, (str, os.PathLike)):
        variables = torch.load(variables, map_location=device, weights_only=True)
    if variables is not None and "model" in variables:
        model.load_state_dict(variables["model"])
    elif variables is not None:
        load_flax_variables(model, {k: variables[k] for k in ("params", "batch_stats")})


@dataclasses.dataclass
class DeepOdometryConfig:
    model: PWCLONetConfig = dataclasses.field(default_factory=PWCLONetConfig)
    num_points: int = 8192


class PWCLONetOdometry:
    """PWCLO-Net frame-to-frame odometry (inference).

    ``variables``: a checkpoint of the port's trainer (its path, or the
    loaded dict, whose ``"model"`` entry is the network's state dict), a Flax
    tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays from the
    reference's trainer (other entries of an exported train state are left
    aside), or None for the seeded init of
    ``PWCLONet(seed=seed)``. The network predicts the pose of the
    **current** frame in the previous frame's coordinates (finest level,
    index 0). Runs on ``device``, CUDA unless the caller asks for the CPU.
    """

    def __init__(self, variables: Union[None, Mapping, str, os.PathLike] = None,
                 config: Optional[DeepOdometryConfig] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.config = config or DeepOdometryConfig()
        self.device = resolve_device(device)
        self.model = PWCLONet(self.config.model, seed=seed, device=self.device)
        _load_variables(self.model, variables, self.device)
        self.state_pose: Optional[np.ndarray] = None
        self._prev_scan: Optional[np.ndarray] = None
        self.poses: list = []

    def init(self):
        self.state_pose = np.eye(4)
        self._prev_scan = None
        self.poses = []

    def _prepare(self, points: np.ndarray) -> np.ndarray:
        n = self.config.num_points
        pts = points[np.linalg.norm(points, axis=-1) > 1e-6]
        if len(pts) >= n:
            idx = np.random.default_rng(len(pts)).choice(len(pts), n, replace=False)
            pts = pts[idx]
        else:
            extra = np.random.default_rng(0).choice(len(pts), n - len(pts), replace=True)
            pts = np.concatenate([pts, pts[extra]])
        return pts.astype(np.float32)

    @torch.inference_mode()
    def _relative_poses(self, cur: np.ndarray, prev: np.ndarray) -> np.ndarray:
        """Finest-level relative poses ``(B, 4, 4)`` float64 of pairs
        ``cur (B, N, 3)`` (xyz1) against ``prev (B, N, 3)`` (xyz2)."""
        x1 = torch.from_numpy(cur).to(self.device)
        x2 = torch.from_numpy(prev).to(self.device)
        params, _ = self.model(x1, x2)
        return se3.params_to_pose_quat(params[:, 0]).cpu().numpy().astype(np.float64)

    def process_next_frame(self, points: np.ndarray) -> np.ndarray:
        scan = self._prepare(points)
        if self._prev_scan is None:
            self._prev_scan = scan
            self.poses.append(np.eye(4))
            return self.state_pose
        # xyz1 = current, xyz2 = previous
        rel = self._relative_poses(scan[None], self._prev_scan[None])[0]
        self.state_pose = self.state_pose @ rel
        self._prev_scan = scan
        self.poses.append(self.state_pose.copy())
        return self.state_pose

    def process_sequence(self, scans: np.ndarray) -> np.ndarray:
        """All consecutive pairs of ``scans (T, N, 3)`` in one batched
        forward. Returns ``(T, 4, 4)`` absolute poses of the newly processed
        frames."""
        prepared = np.stack([self._prepare(s) for s in scans])
        first_poses = []
        if self._prev_scan is None:
            prev = prepared[:-1]
            cur = prepared[1:]
            first_poses.append(np.eye(4))
        else:
            prev = np.concatenate([self._prev_scan[None], prepared[:-1]])
            cur = prepared
        rels = self._relative_poses(cur, prev) if len(cur) else np.zeros((0, 4, 4))
        out = []
        for _ in first_poses:
            self.poses.append(self.state_pose.copy())
            out.append(self.state_pose.copy())
        for rel in rels:
            self.state_pose = self.state_pose @ rel
            self.poses.append(self.state_pose.copy())
            out.append(self.state_pose.copy())
        self._prev_scan = prepared[-1]
        return np.stack(out)

    def absolute_poses(self) -> np.ndarray:
        return np.stack(self.poses)

    def relative_poses(self) -> np.ndarray:
        return compute_relative_poses(self.absolute_poses())


@dataclasses.dataclass
class PoseNetOdometryConfig:
    model: PoseResNetConfig = dataclasses.field(default_factory=PoseResNetConfig)
    projector: SphericalProjector = SphericalProjector()


class PoseNetOdometry:
    """PoseResNet odometry over vertex-map pairs (inference).

    ``variables`` as for :class:`PWCLONetOdometry` (a port checkpoint, a
    Flax tree, or None for the seeded init of ``PoseResNet(seed=seed)``).
    Each scan is projected into a vertex map on the device; the network
    takes ``[current, previous]`` and predicts the current frame's pose in
    the previous frame's coordinates as (t, euler). Convolutions run in
    full fp32. Runs on ``device``, CUDA unless the caller asks for the CPU.
    """

    def __init__(self, variables: Union[None, Mapping, str, os.PathLike] = None,
                 config: Optional[PoseNetOdometryConfig] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.config = config or PoseNetOdometryConfig()
        self.device = resolve_device(device)
        self.model = PoseResNet(self.config.model, seed=seed, device=self.device)
        _load_variables(self.model, variables, self.device)
        self.state_pose: Optional[np.ndarray] = None
        self._prev_vm: Optional[torch.Tensor] = None
        self.poses: list = []

    def init(self):
        self.state_pose = np.eye(4)
        self._prev_vm = None
        self.poses = []

    def _project(self, scans: np.ndarray) -> torch.Tensor:
        """``(T, N, 3)`` scans → ``(T, H, W, 3)`` vertex maps on the device."""
        pts = torch.from_numpy(np.ascontiguousarray(scans, dtype=np.float32)).to(self.device)
        return self.config.projector.build_projection_map(pts)

    @torch.inference_mode()
    def _relative_poses(self, prev_vm: torch.Tensor, cur_vm: torch.Tensor) -> np.ndarray:
        """Relative poses ``(B, 4, 4)`` float64 of the vertex-map pairs."""
        with conv_precision():
            params = self.model(torch.stack([cur_vm, prev_vm], dim=1))[:, 0]
        return se3.params_to_pose_euler(params).cpu().numpy().astype(np.float64)

    def process_next_frame(self, points: np.ndarray) -> np.ndarray:
        vm = self._project(points[None])
        if self._prev_vm is None:
            self._prev_vm = vm
            self.poses.append(np.eye(4))
            return self.state_pose
        self.state_pose = self.state_pose @ self._relative_poses(self._prev_vm, vm)[0]
        self._prev_vm = vm
        self.poses.append(self.state_pose.copy())
        return self.state_pose

    def process_sequence(self, scans: np.ndarray) -> np.ndarray:
        """All consecutive vertex-map pairs of ``scans (T, N, 3)`` in one
        batched forward. Returns the ``(T, 4, 4)`` absolute poses of the
        newly processed frames."""
        vms = self._project(scans)
        first = self._prev_vm is None
        prev = vms[:-1] if first else torch.cat([self._prev_vm, vms[:-1]])
        cur = vms[1:] if first else vms
        rels = self._relative_poses(prev, cur) if len(cur) else np.zeros((0, 4, 4))
        out = [self.state_pose.copy()] if first else []
        for rel in rels:
            self.state_pose = self.state_pose @ rel
            out.append(self.state_pose.copy())
        self.poses += [p.copy() for p in out]
        self._prev_vm = vms[-1:]
        return np.stack(out)

    def absolute_poses(self) -> np.ndarray:
        return np.stack(self.poses)

    def relative_poses(self) -> np.ndarray:
        return compute_relative_poses(self.absolute_poses())
