"""Pose file IO: CSV pose files (N×12 flattened 3×4).

The port's own copy of ``pwclonet_pylidarslam_tpu/utils/io.py``.
"""

from __future__ import annotations

import numpy as np

_COLUMNS = [f"pose_{r}{c}" for r in range(3) for c in range(4)]


def write_poses_csv(path: str, poses: np.ndarray):
    """``(T, 4, 4)`` → csv with header, 12 columns (ref ``poses_to_df:74``)."""
    flat = poses[:, :3, :4].reshape(len(poses), 12)
    np.savetxt(path, flat, delimiter=",", header=",".join(_COLUMNS), comments="")


def read_poses_csv(path: str) -> np.ndarray:
    flat = np.loadtxt(path, delimiter=",", skiprows=1).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(flat), 1, 1))
    poses[:, :3, :4] = flat.reshape(-1, 3, 4)
    return poses
