"""Initialization modules: motion priors for the odometry front-end.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/initialization.py``.
Each implements ``init()`` / ``next_frame(points, last_absolute_pose) →
init_rpose (4,4)``, the predicted relative motion of the incoming frame,
and ``feed_result(relative_pose)``. The ICP odometry keeps its own
constant-velocity prior in its state; these classes serve pipelines that
plug priors in.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core.registration import BEVConfig, planar_to_pose, register_bev
from pwclonet_pylidarslam_torch.device import resolve_device


class NoInitialization:
    """Identity prior."""

    def init(self):
        pass

    def next_frame(self, points, last_absolute_pose) -> np.ndarray:
        return np.eye(4)

    def feed_result(self, relative_pose: np.ndarray):
        pass


class ConstantVelocityInitialization:
    """Returns the last observed relative pose."""

    def init(self):
        self._last_rel = np.eye(4)

    def next_frame(self, points, last_absolute_pose) -> np.ndarray:
        return self._last_rel

    def feed_result(self, relative_pose: np.ndarray):
        self._last_rel = np.asarray(relative_pose, np.float64)


class ElevationImageInitialization:
    """BEV spectral-registration prior between consecutive frames, on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, bev_config=None, device: Union[str, torch.device] = "cuda"):
        self.bev = bev_config or BEVConfig(pixel_size=0.4, image_size=256)
        self.device = resolve_device(device)
        self._prev = None

    def init(self):
        self._prev = None

    def next_frame(self, points, last_absolute_pose) -> np.ndarray:
        pts = np.asarray(points, np.float32)
        mask = (np.linalg.norm(pts, axis=-1) > 1e-6).astype(np.float32)
        if self._prev is None:
            self._prev = (pts, mask)
            return np.eye(4)
        prev_pts, prev_mask = self._prev
        dev = self.device
        reg = register_bev(
            torch.from_numpy(prev_pts).to(dev), torch.from_numpy(prev_mask).to(dev),
            torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev), self.bev,
        )
        self._prev = (pts, mask)
        return planar_to_pose(reg).cpu().numpy().astype(np.float64)

    def feed_result(self, relative_pose: np.ndarray):
        pass


class PoseNetInitialization:
    """Network prior from any deep odometry front-end exposing ``init()``
    and ``process_next_frame(points) -> absolute pose``."""

    def __init__(self, deep_odometry):
        self.deep = deep_odometry

    def init(self):
        self.deep.init()
        self._last_abs = np.eye(4)

    def next_frame(self, points, last_absolute_pose) -> np.ndarray:
        new_abs = self.deep.process_next_frame(points)
        rel = np.linalg.inv(self._last_abs) @ new_abs
        self._last_abs = new_abs
        return rel

    def feed_result(self, relative_pose: np.ndarray):
        pass


INITIALIZATION = {
    "none": NoInitialization,
    "CV": ConstantVelocityInitialization,
    "EI": ElevationImageInitialization,
    "PoseNet": PoseNetInitialization,
}
