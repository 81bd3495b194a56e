"""Deep LiDAR odometry (inference) in PyTorch: PWCLO-Net and PoseResNet.

Counterpart of ``PWCLONetOdometry`` and ``PoseNetOdometry`` in
``pwclonet_pylidarslam_tpu/slam/deep_odometry.py``: prepare each scan on the
device (a fixed point count for PWCLO-Net, a chunk's scans at once, see
:mod:`ops.prepare`; a vertex map for PoseResNet), run the network on each
consecutive frame pair on the device, and chain the relative poses on the
host in float64.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation.metrics import compute_relative_poses
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig, load_flax_variables
from pwclonet_pylidarslam_torch.models.posenet import PoseResNet, PoseResNetConfig, conv_precision
from pwclonet_pylidarslam_torch.ops import prepare
from pwclonet_pylidarslam_torch.utils.timer import count, span


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
        self._prev_scan: Optional[torch.Tensor] = None  # the last prepared scan, on the device
        self._row_buffer: Optional[torch.Tensor] = None
        self.poses: list = []

    def init(self):
        self.state_pose = np.eye(4)
        self._prev_scan = None
        self.poses = []

    def _rows(self, total: int, dtype: torch.dtype) -> torch.Tensor:
        """The first ``total`` rows of the upload buffer, ``(total, 3)`` of
        ``dtype`` on the device: kept across calls, made anew when a chunk
        needs more rows or another dtype."""
        buf = self._row_buffer
        if buf is None or len(buf) < total or buf.dtype != dtype:
            self._row_buffer = buf = torch.empty((total, 3), dtype=dtype, device=self.device)
        return buf[:total]

    def _prepare(self, scans: Sequence[np.ndarray],
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Each of ``scans`` (``(hits, 3)`` rows, all float32 or all float64)
        as the network takes it, on the device: its rows at the origin
        dropped, by numpy's norm in the scans' dtype, then ``num_points``
        drawn and rounded to float32 (:func:`ops.prepare.prepare`).
        ``(T, n, 3)`` float32, or, after ``prev (n, 3)``, ``(T + 1, n, 3)``,
        ``prev`` first. The scans' rows go to the device as they are, each
        into its place in one buffer; the host makes only the draws, from
        the counts of kept rows. Raises ``TypeError`` on scans of another
        dtype, or of both."""
        scans = [np.ascontiguousarray(s) for s in scans]
        dtypes = {str(s.dtype) for s in scans}
        if len(dtypes) > 1 or not dtypes <= {"float32", "float64"}:
            raise TypeError(f"scans must be all float32 or all float64, got {sorted(dtypes)}")
        offsets = np.zeros(len(scans) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in scans], out=offsets[1:])
        total = int(offsets[-1])
        count("odometry.points_in", total)
        with span("odometry.h2d"):
            rows = self._rows(total, torch.float64 if "float64" in dtypes else torch.float32)
            for scan, lo in zip(scans, offsets.tolist()):
                rows[lo: lo + len(scan)].copy_(torch.from_numpy(scan), non_blocking=True)
            first = torch.from_numpy(offsets).to(self.device, non_blocking=True)
            count("h2d.bytes", rows.nbytes + offsets.nbytes)
        n = self.config.num_points
        out = torch.empty((len(scans) + (prev is not None), n, 3), dtype=torch.float32,
                          device=self.device)
        if prev is not None:
            out[0] = prev
        prepare.prepare(rows, first, n, out=out[len(out) - len(scans):])
        return out

    @torch.inference_mode()
    def _relative_poses(self, cur: torch.Tensor, prev: torch.Tensor) -> np.ndarray:
        """Finest-level relative poses ``(B, 4, 4)`` float64 of pairs
        ``cur (B, N, 3)`` (xyz1) against ``prev (B, N, 3)`` (xyz2), both on
        the device."""
        with span("odometry.forward"):
            params, _ = self.model(cur, prev)
            poses = se3.params_to_pose_quat(params[:, 0])
        with span("odometry.readback"):
            return poses.cpu().numpy().astype(np.float64)

    @span("odometry.call")
    def process_next_frame(self, points: np.ndarray) -> np.ndarray:
        with span("odometry.prepare"):
            prepared = self._prepare([points], self._prev_scan)
        if self._prev_scan is None:
            self._prev_scan = prepared[0]
            self.poses.append(np.eye(4))
            return self.state_pose
        # xyz1 = current, xyz2 = previous
        rel = self._relative_poses(prepared[1:], prepared[:1])[0]
        with span("odometry.chain"):
            self.state_pose = self.state_pose @ rel
            self._prev_scan = prepared[1]
            self.poses.append(self.state_pose.copy())
        return self.state_pose

    @span("odometry.call")
    def process_sequence(self, scans: Sequence[np.ndarray]) -> np.ndarray:
        """All consecutive pairs of ``scans`` (``(T, N, 3)``, or T scans of
        any row counts) in one batched forward. Returns ``(T, 4, 4)``
        absolute poses of the newly processed frames."""
        first = self._prev_scan is None
        with span("odometry.prepare"):
            prepared = self._prepare(scans, self._prev_scan)
        cur, prev = prepared[1:], prepared[:-1]
        rels = self._relative_poses(cur, prev) if len(cur) else np.zeros((0, 4, 4))
        with span("odometry.chain"):
            out = []
            if first:
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
