"""SLAM orchestrator: odometry, loop closure and the pose-graph back end.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/pipeline.py``. State
flows through explicit objects:

- odometry: any object with ``init()`` and ``process_next_frame(points) →
  pose`` (:class:`~pwclonet_pylidarslam_torch.slam.icp_odometry.ICPOdometry`
  by default, or ``PWCLONetOdometry``);
- loop closure: :class:`~pwclonet_pylidarslam_torch.slam.loop_closure.ElevationImageLoopClosure`;
- back end: an incremental
  :class:`~pwclonet_pylidarslam_torch.slam.backend.PoseGraphBuilder`,
  optimized on the device whenever a loop constraint arrives (or, if
  configured, an absolute one), after which every component is resynced to
  the corrected trajectory.

Runs on ``device``, CUDA unless the caller asks for the CPU; a given
odometry brings its own device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation.metrics import compute_relative_poses
from pwclonet_pylidarslam_torch.slam import backend as backend_mod
from pwclonet_pylidarslam_torch.slam.icp_odometry import ICPConfig, ICPOdometry
from pwclonet_pylidarslam_torch.slam.loop_closure import (
    ElevationImageLoopClosure,
    LoopClosureConfig,
)


@dataclasses.dataclass
class SLAMConfig:
    """The reference's ``SLAMConfig``."""

    odometry: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    with_loop_closure: bool = False
    loop_closure: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    with_backend: bool = False
    backend_max_nodes: int = 8192
    backend_max_edges: int = 16384
    backend_max_priors: int = 256
    # the reference only re-optimizes when a loop edge arrives; set this to
    # also optimize whenever a GPS/absolute constraint is attached
    optimize_on_absolute: bool = False
    pgo: backend_mod.PGOConfig = dataclasses.field(default_factory=backend_mod.PGOConfig)


class SLAM:
    """Online SLAM over one sequence.

    ``optimizations`` holds one record a back-end run: seconds, the
    :class:`~pwclonet_pylidarslam_torch.slam.backend.PGOStats` and the node
    count.
    """

    def __init__(self, config: Optional[SLAMConfig] = None, odometry=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or SLAMConfig()
        self.device = resolve_device(device)
        self.odometry = odometry or ICPOdometry(self.config.odometry, device=self.device)
        self.loop_closure = (
            ElevationImageLoopClosure(self.config.loop_closure, device=self.device)
            if self.config.with_loop_closure
            else None
        )
        self.builder: Optional[backend_mod.PoseGraphBuilder] = None
        self._optimized_poses: Optional[np.ndarray] = None
        self._prev_pose = None
        self.elapsed: List[float] = []
        self.optimizations: List[dict] = []

    def init(self):
        self.odometry.init()
        if self.loop_closure is not None:
            self.loop_closure.reset()
        if self.config.with_backend:
            self.builder = backend_mod.PoseGraphBuilder(
                self.config.backend_max_nodes,
                self.config.backend_max_edges,
                self.config.backend_max_priors,
            )
        self._optimized_poses = None
        self._prev_pose = None
        self.elapsed = []
        self.optimizations = []

    def process_next_frame(
        self,
        points: np.ndarray,
        absolute_pose_gps: Optional[np.ndarray] = None,
        absolute_information: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """One frame ``(N, 3)`` → current absolute pose estimate ``(4, 4)``.

        ``absolute_pose_gps``: an optional GPS/absolute measurement of this
        frame's pose, added to the pose graph as a unary prior.
        """
        t0 = time.perf_counter()
        pose = self.odometry.process_next_frame(points)

        has_absolute = False
        if self.builder is not None:
            node = self.builder.add_node(pose)
            if node > 0:
                rel = np.linalg.inv(self._prev_pose) @ pose
                self.builder.add_odometry_edge(node - 1, rel)
            if absolute_pose_gps is not None:
                self.builder.add_absolute_edge(node, absolute_pose_gps, absolute_information)
                has_absolute = True
        self._prev_pose = pose

        new_constraints = []
        if self.loop_closure is not None:
            new_constraints = self.loop_closure.process_next_frame(points, pose)
            if self.builder is not None:
                for c in new_constraints:
                    self.builder.add_loop_edge(c.frame_i, c.frame_j, c.relative_pose)

        # optimize only when a loop constraint arrives, or, if configured,
        # when an absolute constraint is attached
        if self.builder is not None and (
            new_constraints or (has_absolute and self.config.optimize_on_absolute)
        ):
            pose = self.optimize_now()

        self.elapsed.append(time.perf_counter() - t0)
        return pose

    def optimize_now(self) -> np.ndarray:
        """Force a pose-graph optimization and a resync of every component;
        returns the corrected current pose."""
        t0 = time.perf_counter()
        graph = self.builder.to_device(device=self.device)
        stats = backend_mod.PGOStats()
        out = backend_mod.optimize(graph, self.config.pgo, stats)
        n = len(self.builder.poses)
        optimized = out.poses[:n].cpu().numpy().astype(np.float64)
        stats.host_reads += 1  # the fetch
        self.optimizations.append(
            {"seconds": time.perf_counter() - t0, "stats": stats, "nodes": n})
        self._optimized_poses = optimized
        # resync all components to the corrected trajectory
        self.builder.poses = [optimized[i] for i in range(n)]
        if self.loop_closure is not None:
            self.loop_closure.update_positions(optimized)
        self._prev_pose = optimized[-1]
        self._resync_odometry(optimized[-1])
        return optimized[-1]

    def _resync_odometry(self, corrected_pose: np.ndarray):
        """Push the back-end-corrected pose into the odometry state so that
        later frames integrate from the optimized trajectory.

        The correction is a left world-frame transform ``C = corrected·old⁻¹``
        applied to EVERY absolute pose the odometry state carries: ``pose``,
        ``last_kf_pose``, ``model_pose`` and the keyframe poses of the map
        (correcting only ``pose`` would shear the map by the correction on
        the next model re-projection). An odometry without such a state
        (``PWCLONetOdometry``) is left as it is, as in the reference.
        """
        state = getattr(self.odometry, "state", None)
        if state is not None and hasattr(state, "pose"):
            old = state.pose.cpu().numpy().astype(np.float64)
            c = np.asarray(corrected_pose, np.float64) @ np.linalg.inv(old)
            cj = torch.as_tensor(c, dtype=state.pose.dtype, device=state.pose.device)
            replacements = {"pose": cj @ state.pose}
            if hasattr(state, "last_kf_pose"):
                replacements["last_kf_pose"] = cj @ state.last_kf_pose
            if hasattr(state, "model_pose"):
                replacements["model_pose"] = cj @ state.model_pose
            if hasattr(state, "map") and hasattr(state.map, "poses"):
                replacements["map"] = state.map._replace(poses=cj[None] @ state.map.poses)
            self.odometry.state = state._replace(**replacements)

    def absolute_poses(self) -> np.ndarray:
        if self.builder is not None and self.builder.poses:
            return np.stack(self.builder.poses)
        return self.odometry.absolute_poses()

    def relative_poses(self) -> np.ndarray:
        return compute_relative_poses(self.absolute_poses())

    # --- full-pipeline snapshots, in the reference's file layout

    def snapshot(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        if hasattr(self.odometry, "snapshot"):
            self.odometry.snapshot(os.path.join(directory, "odometry.npz"))
        if self.loop_closure is not None:
            self.loop_closure.serialize(os.path.join(directory, "loop_closure.npz"))
        misc = {"elapsed": np.asarray(self.elapsed)}
        if self._prev_pose is not None:
            misc["prev_pose"] = np.asarray(self._prev_pose)
        if self._optimized_poses is not None:
            misc["optimized_poses"] = self._optimized_poses
        if self.builder is not None and self.builder.poses:
            misc["graph_poses"] = np.stack(self.builder.poses)
            if self.builder.edges:
                misc["edge_i"] = np.asarray([e[0] for e in self.builder.edges])
                misc["edge_j"] = np.asarray([e[1] for e in self.builder.edges])
                misc["edge_meas"] = np.stack([e[2] for e in self.builder.edges])
                misc["edge_info"] = np.stack([e[3] for e in self.builder.edges])
            if self.builder.priors:
                misc["prior_node"] = np.asarray([p[0] for p in self.builder.priors])
                misc["prior_meas"] = np.stack([p[1] for p in self.builder.priors])
                misc["prior_info"] = np.stack([p[2] for p in self.builder.priors])
        np.savez_compressed(os.path.join(directory, "pipeline.npz"), **misc)

    def restore(self, directory: str) -> None:
        self.init()
        if hasattr(self.odometry, "restore"):
            self.odometry.restore(os.path.join(directory, "odometry.npz"))
        lc_path = os.path.join(directory, "loop_closure.npz")
        if self.loop_closure is not None and os.path.exists(lc_path):
            self.loop_closure.load(lc_path)
        data = np.load(os.path.join(directory, "pipeline.npz"))
        self.elapsed = list(data["elapsed"])
        if "prev_pose" in data:
            self._prev_pose = data["prev_pose"]
        if "optimized_poses" in data:
            self._optimized_poses = data["optimized_poses"]
        if self.builder is not None and "graph_poses" in data:
            self.builder.poses = [p for p in data["graph_poses"]]
            if "edge_i" in data:
                self.builder.edges = [
                    (int(i), int(j), m, info)
                    for i, j, m, info in zip(
                        data["edge_i"], data["edge_j"], data["edge_meas"], data["edge_info"]
                    )
                ]
            if "prior_node" in data:
                self.builder.priors = [
                    (int(i), m, info)
                    for i, m, info in zip(data["prior_node"], data["prior_meas"], data["prior_info"])
                ]
