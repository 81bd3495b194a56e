"""KITTI odometry dataset: scan IO, calibration, GT poses, training pairs.

The port's own copy of ``pwclonet_pylidarslam_tpu/data/kitti.py`` (numpy on
the host; the quaternion of a ground-truth pose comes from the port's
``core/rotation.py``). Two KITTI paths:
- SLAM path (``slam/dataset/kitti_dataset.py``): per-frame scans in the lidar
  frame with GT poses re-based through the ``Tr`` calibration, plus the
  0.205° HDL-64 intrinsic scan correction (``:209-249``);
- training path (``slam/dataset/kitti_odometry_dataset.py``): frame pairs in
  the cam0 frame, ground/range filtered and sampled to exactly
  ``num_points`` (``filter_pcd:149-172``), with random SE(3) augmentation of
  the second cloud and GT adjustment (``:401-447``).

Layout expected under ``root_dir`` (standard KITTI odometry benchmark):
``sequences/NN/velodyne/XXXXXX.bin``, ``sequences/NN/calib.txt`` (or
``calib/NN/calib.txt``), ``poses/NN.txt``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import rotation as rot

SEQUENCE_SIZES = {
    0: 4541, 1: 1101, 2: 4661, 3: 801, 4: 271, 5: 2761,
    6: 1101, 7: 1101, 8: 4071, 9: 1591, 10: 1201,
}


def read_scan(path: str) -> np.ndarray:
    """KITTI velodyne ``.bin`` → ``(N, 4)`` float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_calib(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            tokens = line.strip().split(" ")
            if not tokens or tokens[0] == "calib_time:" or tokens[0] == "":
                continue
            key = tokens[0].rstrip(":")
            try:
                out[key] = np.asarray([float(t) for t in tokens[1:]], np.float64)
            except ValueError:
                continue
    return out


def read_poses(path: str) -> np.ndarray:
    """KITTI GT pose file (N rows × 12) → ``(N, 4, 4)`` cam0 poses."""
    flat = np.loadtxt(path).reshape(-1, 12)
    n = flat.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = flat.reshape(n, 3, 4)
    return poses


def load_tr(root_dir: str, sequence: int) -> np.ndarray:
    """The velo→cam0 ``Tr`` 4×4 for a sequence. Checks both standard layouts."""
    seq = f"{sequence:02d}"
    for cand in (
        os.path.join(root_dir, "sequences", seq, "calib.txt"),
        os.path.join(root_dir, "calib", seq, "calib.txt"),
    ):
        if os.path.exists(cand):
            tr = read_calib(cand)["Tr"].reshape(3, 4)
            return np.vstack([tr, [0.0, 0.0, 0.0, 1.0]])
    raise FileNotFoundError(f"no calib.txt for sequence {seq} under {root_dir}")


def correct_scan(xyz: np.ndarray, theta_deg: float = 0.205) -> np.ndarray:
    """HDL-64 intrinsic correction: rotate each point by 0.205° about the
    axis ``p × ẑ`` (ref ``kitti_dataset.correct_scan:209-249``), i.e. a small
    elevation-angle fix. Vectorized Rodrigues instead of per-point matrices.
    """
    z = np.array([0.0, 0.0, 1.0])
    axes = np.cross(xyz, z)
    norms = np.linalg.norm(axes, axis=1, keepdims=True)
    axes = axes / np.maximum(norms, 1e-12)
    theta = np.deg2rad(theta_deg)
    c, s = np.cos(theta), np.sin(theta)
    dot = np.sum(axes * xyz, axis=1, keepdims=True)
    return (
        c * xyz + s * np.cross(axes, xyz) + (1 - c) * dot * axes
    ).astype(xyz.dtype)


def lidar_pose_gt(cam_poses: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """Re-base cam0 GT poses into the lidar frame:
    ``P_lidar = Tr⁻¹ · P_cam · Tr`` (ref ``kitti_dataset.__lidar_pose_gt:197-204``)."""
    tr_inv = np.linalg.inv(tr)
    return np.einsum("ij,tjk,kl->til", tr_inv, cam_poses, tr)


@dataclasses.dataclass
class KittiSequence:
    """SLAM-path sequence: iterate per-frame lidar scans + GT lidar poses."""

    root_dir: str
    sequence: int
    apply_correction: bool = True

    def __post_init__(self):
        seq = f"{self.sequence:02d}"
        self.velodyne_dir = os.path.join(self.root_dir, "sequences", seq, "velodyne")
        self.tr = load_tr(self.root_dir, self.sequence)
        pose_file = os.path.join(self.root_dir, "poses", f"{seq}.txt")
        self.cam_poses = read_poses(pose_file) if os.path.exists(pose_file) else None
        files = sorted(os.listdir(self.velodyne_dir))
        self.num_frames = len(files)

    def __len__(self):
        return self.num_frames

    def scan(self, idx: int) -> np.ndarray:
        pts = read_scan(
            os.path.join(self.velodyne_dir, f"{idx:06d}.bin")
        )[:, :3]
        if self.apply_correction:
            pts = correct_scan(pts)
        return pts

    def ground_truth(self) -> Optional[np.ndarray]:
        if self.cam_poses is None:
            return None
        return lidar_pose_gt(self.cam_poses, self.tr)


def filter_pcd(
    points_cam: np.ndarray, num_points: int, rng: np.random.Generator
) -> np.ndarray:
    """Ground/range filter + sample to exactly ``num_points``
    (ref ``kitti_odometry_dataset.filter_pcd:149-172``; camera coords: y down
    → ground is y > 1.1, near box |x| < 30 ∧ |z| < 30)."""
    is_ground = points_cam[:, 1] > 1.1
    near = (
        (np.abs(points_cam[:, 0]) < 30)
        & (np.abs(points_cam[:, 2]) < 30)
        & ~is_ground
    )
    idx = np.nonzero(near)[0]
    if len(idx) >= num_points:
        sel = rng.choice(idx, num_points, replace=False)
    elif len(idx) > 0:
        sel = np.concatenate([idx, rng.choice(idx, num_points - len(idx), replace=True)])
    else:
        sel = rng.choice(len(points_cam), num_points, replace=True)
    return points_cam[sel]


def random_augmentation(rng: np.random.Generator) -> np.ndarray:
    """The training-time random SE(3) augmentation T_trans
    (ref ``kitti_odometry_dataset.py:404-436``): small clipped-gaussian euler
    angles (y dominant — yaw in cam coords) + translation (z dominant)."""
    ax = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    ay = np.clip(0.05 * rng.standard_normal(), -0.1, 0.1) * np.pi / 4.0
    az = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0

    def rot(c, s, kind):
        if kind == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if kind == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    r = (
        rot(np.cos(ax), np.sin(ax), "x")
        @ rot(np.cos(ay), np.sin(ay), "y")
        @ rot(np.cos(az), np.sin(az), "z")
    )
    t = np.array(
        [
            np.clip(0.1 * rng.standard_normal(), -0.2, 0.2),
            np.clip(0.05 * rng.standard_normal(), -0.15, 0.15),
            np.clip(0.5 * rng.standard_normal(), -1.0, 1.0),
        ]
    )
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def pose_to_params(pose: np.ndarray) -> np.ndarray:
    """A 4×4 pose → ``(7,)`` float32 ``(t, q_wxyz)``, the quaternion taken in
    float64 and with ``w >= 0``."""
    q = rot.mat_to_quat(torch.from_numpy(np.ascontiguousarray(pose[:3, :3], np.float64)))
    return np.concatenate([pose[:3, 3], q.numpy()]).astype(np.float32)


@dataclasses.dataclass
class KittiPairDataset:
    """Training pairs for PWCLO-Net (ref ``KittiOdometryDataset``).

    ``__getitem__`` returns a dict batch element:
    ``{"xyz1": (N,3) current frame (pc2), "xyz2": (N,3) previous frame (pc1),
    "gt_params": (7,) = (t, q_wxyz) mapping xyz1 coords → xyz2 coords}``.
    Everything in cam0 coordinates, like the reference training path.
    """

    root_dir: str
    sequences: Sequence[int]
    num_points: int = 8192
    max_frame_gap: int = 1
    augment: bool = False
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._seq_data = {}
        self._index = []  # (seq, frame_idx)
        for s in self.sequences:
            seq = f"{s:02d}"
            vdir = os.path.join(self.root_dir, "sequences", seq, "velodyne")
            n = len(sorted(os.listdir(vdir)))
            tr = load_tr(self.root_dir, s)
            poses = read_poses(os.path.join(self.root_dir, "poses", f"{seq}.txt"))
            self._seq_data[s] = (vdir, tr, poses)
            self._index.extend((s, i) for i in range(n))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        seq, i2 = self._index[index]
        vdir, tr, poses = self._seq_data[seq]
        gap = int(self._rng.integers(1, self.max_frame_gap + 1))
        i1 = max(i2 - gap, 0)

        def load(i):
            pts = read_scan(os.path.join(vdir, f"{i:06d}.bin"))
            n = pts.shape[0]
            hom = np.concatenate([pts[:, :3], np.ones((n, 1))], axis=-1)
            return (tr @ hom.T).T[:, :3]

        p1 = load(i1)
        p2 = load(i2)
        n = min(len(p1), len(p2))
        p1, p2 = p1[:n], p2[:n]
        p1 = filter_pcd(p1, self.num_points, self._rng)
        p2 = filter_pcd(p2, self.num_points, self._rng)

        # GT relative pose in cam coords: p1 ≈ T_diff · p2
        t_diff = np.linalg.inv(poses[i1]) @ poses[i2]
        if self.augment:
            t_aug = random_augmentation(self._rng)
            hom = np.concatenate([p2, np.ones((self.num_points, 1))], -1)
            p2 = (t_aug @ hom.T).T[:, :3]
            t_gt = t_diff @ np.linalg.inv(t_aug)
        else:
            t_gt = t_diff

        return {
            "xyz1": p2.astype(np.float32),
            "xyz2": p1.astype(np.float32),
            "gt_params": pose_to_params(t_gt),
        }

    def batches(self, batch_size: int, shuffle: bool = True):
        """Simple host-side batch iterator (stacks dict fields)."""
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(i)] for i in order[start : start + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
