"""Additional dataset readers: KITTI-360, NCLT, Ford Campus, NHCD, PLY
directories, KITTI-CARLA.

The port's own copy of ``pwclonet_pylidarslam_tpu/data/other_datasets.py``
(host numpy; the quaternion of a training pair's ground truth comes from the
port's ``core/rotation.py``, its filter and augmentation from the port's
``data/kitti.py``). The readers of the remaining reference loaders:
- KITTI-360 (``slam/dataset/kitti_360_dataset.py``): raw velodyne bins under
  ``data_3d_raw`` with cam0↔velo pose chains under ``data_poses``;
- NCLT (``nclt_dataset.py``): HDL-32 packed uint16 binary with the UMich
  scaling/offset decode, GT csv interpolated by timestamp;
- Ford Campus (``ford_dataset.py``): per-scan ``.mat`` files;
- NHCD / Newer College (``nhcd_dataset.py``): ply frames + GT csv with
  timestamp matching;
- the CT-ICP PLY-frame formats (``PLY_DIR``, KITTI-CARLA).

All expose the same minimal ``SequenceSource`` protocol as
:class:`data.kitti.KittiSequence` (``__len__`` / ``scan(i)`` /
``ground_truth()``), so every reader plugs into :class:`slam.runner.SLAMRunner`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from pwclonet_pylidarslam_torch.data.kitti import filter_pcd, pose_to_params, random_augmentation


# ---------------------------------------------------------------------------
# KITTI-360
# ---------------------------------------------------------------------------


def kitti360_drive_name(sequence: int) -> str:
    """Drive folder naming (ref ``kitti360_utils.KITTI360_IO:195``)."""
    return f"2013_05_28_drive_{sequence:04d}_sync"


@dataclasses.dataclass
class Kitti360Sequence:
    """SLAM-path reader for a KITTI-360 drive.

    Expects ``<root>/data_3d_raw/<drive>/velodyne_points/data/*.bin`` and
    ``<root>/data_poses/<drive>/poses.txt`` (frame-indexed cam0 poses) plus
    ``<root>/calibration/calib_cam_to_velo.txt``.
    """

    root_dir: str
    sequence: int

    def __post_init__(self):
        drive = kitti360_drive_name(self.sequence)
        self.velo_dir = os.path.join(
            self.root_dir, "data_3d_raw", drive, "velodyne_points", "data"
        )
        self.files = sorted(os.listdir(self.velo_dir))
        calib = os.path.join(self.root_dir, "calibration", "calib_cam_to_velo.txt")
        if os.path.exists(calib):
            vals = np.loadtxt(calib).reshape(3, 4)
            self.cam_to_velo = np.vstack([vals, [0, 0, 0, 1.0]])
        else:
            self.cam_to_velo = np.eye(4)
        pose_file = os.path.join(self.root_dir, "data_poses", drive, "poses.txt")
        self._poses = None
        if os.path.exists(pose_file):
            raw = np.loadtxt(pose_file)
            # rows: frame_idx + 12 pose values (cam0 -> world)
            self._pose_frames = raw[:, 0].astype(int)
            mats = np.tile(np.eye(4), (len(raw), 1, 1))
            mats[:, :3, :4] = raw[:, 1:13].reshape(-1, 3, 4)
            self._poses = mats

    def __len__(self):
        return len(self.files)

    def scan(self, idx: int) -> np.ndarray:
        pts = np.fromfile(
            os.path.join(self.velo_dir, self.files[idx]), dtype=np.float32
        ).reshape(-1, 4)[:, :3]
        return pts

    def ground_truth(self) -> Optional[np.ndarray]:
        """Velodyne-frame poses interpolated to every scan (KITTI-360 GT is
        sparse — only some frames have poses; ref ``kitti_360_dataset.py:149-154``)."""
        if self._poses is None:
            return None
        velo_to_cam = np.linalg.inv(self.cam_to_velo)
        velo_poses = np.einsum(
            "tij,jk->tik", self._poses @ velo_to_cam[None], np.eye(4)
        )
        # rebase into the velodyne frame of the first posed frame
        velo_poses = np.einsum("ij,tjk->tik", np.linalg.inv(velo_poses[0]), velo_poses)
        # expand to every scan index by nearest posed frame
        out = np.tile(np.eye(4), (len(self.files), 1, 1))
        for i in range(len(self.files)):
            nearest = np.argmin(np.abs(self._pose_frames - i))
            out[i] = velo_poses[nearest]
        return out


@dataclasses.dataclass
class Kitti360PairDataset:
    """Training pairs on KITTI-360 (ref ``kitti_360_dataset_2.py:66-549``).

    Same contract as :class:`data.kitti.KittiPairDataset`: items are
    ``{"xyz1": current, "xyz2": previous, "gt_params": (t, q_wxyz)}`` with the
    GT mapping current-frame coords to previous-frame coords, ground/range
    filtered to ``num_points`` in the cam0 frame, optional SE(3) augmentation
    composed into the GT (ref ``:200-259``).
    """

    root_dir: str
    sequences: tuple
    num_points: int = 8192
    max_frame_gap: int = 1
    augment: bool = False
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._seqs = {}
        self._index = []
        for s in self.sequences:
            seq = Kitti360Sequence(self.root_dir, s)
            if seq._poses is None:
                continue
            velo_poses = seq.ground_truth()
            self._seqs[s] = (seq, velo_poses)
            self._index.extend((s, i) for i in range(len(seq)))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, index: int):
        s, i2 = self._index[index]
        seq, poses = self._seqs[s]
        gap = int(self._rng.integers(1, self.max_frame_gap + 1))
        i1 = max(i2 - gap, 0)
        # velo frame → cam0 frame for the reference's filter conventions
        velo_to_cam = np.linalg.inv(seq.cam_to_velo)

        def load(i):
            pts = seq.scan(i)
            hom = np.concatenate([pts, np.ones((len(pts), 1))], -1)
            return (velo_to_cam @ hom.T).T[:, :3]

        p1 = filter_pcd(load(i1), self.num_points, self._rng)
        p2 = filter_pcd(load(i2), self.num_points, self._rng)
        cam_pose = lambda i: velo_to_cam @ poses[i] @ seq.cam_to_velo
        t_diff = np.linalg.inv(cam_pose(i1)) @ cam_pose(i2)
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
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(i)] for i in order[start : start + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


# ---------------------------------------------------------------------------
# NCLT
# ---------------------------------------------------------------------------


def nclt_decode_scan(raw: np.ndarray) -> np.ndarray:
    """Decode NCLT packed velodyne_sync binary → (N, 3) float meters.

    Layout per point: x_s, y_s, z_s as uint16 + intensity/laser bytes;
    decode = ``v * 0.005 − 100`` (ref ``nclt_dataset._convert:34-41``).
    """
    # records of 8 bytes: 3x uint16 + 2x uint8
    rec = raw.reshape(-1, 4)  # viewed as uint16 quads: x, y, z, (i|l)
    xyz_s = rec[:, :3].astype(np.float32)
    return xyz_s * 0.005 - 100.0


@dataclasses.dataclass
class NCLTSequence:
    """``<root>/<session>/velodyne_sync/*.bin`` + ``groundtruth_<session>.csv``."""

    root_dir: str
    session: str

    def __post_init__(self):
        self.velo_dir = os.path.join(self.root_dir, self.session, "velodyne_sync")
        self.files = sorted(os.listdir(self.velo_dir))
        gt_file = os.path.join(
            self.root_dir, self.session, f"groundtruth_{self.session}.csv"
        )
        self._gt = None
        if os.path.exists(gt_file):
            raw = np.genfromtxt(gt_file, delimiter=",")
            self._gt_times = raw[:, 0]
            # columns: utime, x, y, z, roll, pitch, yaw (NCLT convention)
            self._gt_xyzrpy = raw[:, 1:7]

    def __len__(self):
        return len(self.files)

    def scan_timestamp(self, idx: int) -> float:
        return float(os.path.splitext(self.files[idx])[0])

    def scan(self, idx: int) -> np.ndarray:
        raw = np.fromfile(
            os.path.join(self.velo_dir, self.files[idx]), dtype=np.uint16
        )
        return nclt_decode_scan(raw)

    def ground_truth(self) -> Optional[np.ndarray]:
        if self._gt is None and not hasattr(self, "_gt_times"):
            return None
        from scipy.spatial.transform import Rotation as R

        times = np.asarray([self.scan_timestamp(i) for i in range(len(self))])
        idx = np.clip(
            np.searchsorted(self._gt_times, times), 0, len(self._gt_times) - 1
        )
        sel = self._gt_xyzrpy[idx]
        poses = np.tile(np.eye(4), (len(times), 1, 1))
        poses[:, :3, :3] = R.from_euler("xyz", sel[:, 3:6]).as_matrix()
        poses[:, :3, 3] = sel[:, :3]
        return np.einsum("ij,tjk->tik", np.linalg.inv(poses[0]), poses)


# ---------------------------------------------------------------------------
# Ford Campus
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FordCampusSequence:
    """``<root>/SCANS/Scan*.mat`` with fields ``SCAN.XYZ`` and ``X_wv``
    (ref ``ford_dataset.py:31-117``)."""

    sequence_dir: str

    def __post_init__(self):
        self.scan_dir = os.path.join(self.sequence_dir, "SCANS")
        self.files = sorted(os.listdir(self.scan_dir))

    def __len__(self):
        return len(self.files)

    def _load(self, idx: int):
        from scipy.io import loadmat

        return loadmat(os.path.join(self.scan_dir, self.files[idx]))

    def scan(self, idx: int) -> np.ndarray:
        mat = self._load(idx)
        scan = mat["SCAN"]
        xyz = scan["XYZ"][0, 0] if scan.dtype.names else scan
        return np.ascontiguousarray(np.asarray(xyz, np.float32).T.reshape(-1, 3))

    def ground_truth(self) -> Optional[np.ndarray]:
        from scipy.spatial.transform import Rotation as R

        poses = []
        for i in range(len(self)):
            mat = self._load(i)
            x_wv = np.asarray(mat["SCAN"]["X_wv"][0, 0]).reshape(-1)
            pose = np.eye(4)
            pose[:3, 3] = x_wv[:3]
            pose[:3, :3] = R.from_euler("xyz", x_wv[3:6]).as_matrix()
            poses.append(pose)
        poses = np.stack(poses)
        return np.einsum("ij,tjk->tik", np.linalg.inv(poses[0]), poses)


# ---------------------------------------------------------------------------
# NHCD (Newer College)
# ---------------------------------------------------------------------------


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Typed binary/ascii PLY reader (no plyfile dep): returns a structured
    array with one field per vertex property (mixed dtypes supported — the
    CT-ICP PLY frames mix float coordinates with integer labels)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header if l.startswith("element vertex"))
        props = [l.split()[1:] for l in header if l.startswith("property ")]
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        endian = "<" if "little" in fmt or fmt == "ascii" else ">"
        dtype = np.dtype([(name, endian + _PLY_TYPES[t]) for t, name in props])
        if fmt == "ascii":
            flat = np.loadtxt(f, max_rows=n, ndmin=2)
            out = np.zeros(n, dtype)
            for i, (_, name) in enumerate(props):
                out[name] = flat[:, i]
            return out
        return np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)


def write_ply(path: str, data: np.ndarray) -> None:
    """Binary little-endian PLY writer for structured arrays (fixtures +
    export; counterpart of :func:`read_ply`)."""
    inv = {v: k for k, v in _PLY_TYPES.items()}
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {len(data)}"]
    for name in data.dtype.names:
        kind = data.dtype[name].newbyteorder("<").str.lstrip("<>|=")
        lines.append(f"property {inv[kind]} {name}")
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data.astype(data.dtype.newbyteorder("<"))).tobytes())


def read_ply_xyz(path: str) -> np.ndarray:
    """xyz float32 view of a PLY point cloud."""
    data = read_ply(path)
    return np.ascontiguousarray(
        np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)
    )


@dataclasses.dataclass
class NHCDSequence:
    """``<root>/<sequence>/raw_format/ouster_scan/*.ply`` + GT csv with
    timestamp matching (ref ``nhcd_dataset.py:53-188``)."""

    root_dir: str
    sequence: str

    def __post_init__(self):
        self.scan_dir = os.path.join(
            self.root_dir, self.sequence, "raw_format", "ouster_scan"
        )
        self.files = sorted(os.listdir(self.scan_dir))
        gt = os.path.join(
            self.root_dir, self.sequence, "ground_truth", "registered_poses.csv"
        )
        self._gt_raw = None
        if os.path.exists(gt):
            self._gt_raw = np.genfromtxt(gt, delimiter=",", skip_header=1)

    def __len__(self):
        return len(self.files)

    def _timestamp(self, name: str) -> float:
        # cloud_<secs>_<nsecs>.ply
        toks = os.path.splitext(name)[0].split("_")
        return float(toks[-2]) + float(toks[-1]) * 1e-9

    def scan(self, idx: int) -> np.ndarray:
        return read_ply_xyz(os.path.join(self.scan_dir, self.files[idx]))

    def ground_truth(self) -> Optional[np.ndarray]:
        if self._gt_raw is None:
            return None
        from scipy.spatial.transform import Rotation as R

        sec, nsec = self._gt_raw[:, 0], self._gt_raw[:, 1]
        gt_times = sec + nsec * 1e-9
        xyz = self._gt_raw[:, 2:5]
        qxyzw = self._gt_raw[:, 5:9]
        times = np.asarray([self._timestamp(f) for f in self.files])
        idx = np.clip(np.searchsorted(gt_times, times), 0, len(gt_times) - 1)
        poses = np.tile(np.eye(4), (len(times), 1, 1))
        poses[:, :3, :3] = R.from_quat(qxyzw[idx]).as_matrix()
        poses[:, :3, 3] = xyz[idx]
        return np.einsum("ij,tjk->tik", np.linalg.inv(poses[0]), poses)


# ---------------------------------------------------------------------------
# Generic PLY-frame directories (CT-ICP dataset formats)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PLYDirSequence:
    """Directory of per-frame PLY scans — the CT-ICP ``PLY_DIR`` dataset
    (ref ``slam/dataset/ct_icp_dataset.py:217-218``, which delegates to the
    external ``pyct_icp`` binary; here a native reader).

    - frames: every ``*.ply`` under ``scan_dir``, lexicographically sorted;
    - optional per-point intra-scan timestamps: any of the property names in
      ``time_props`` found in the PLY, min-max normalized to [0, 1] per frame
      (consumed by the elastic CT-ICP odometry / de-skew filters);
    - optional GT: ``poses_file`` with KITTI-style rows of 12 floats
      (flattened 3×4), or 13 columns (timestamp first) — extra columns
      beyond the pose are ignored.
    """

    scan_dir: str
    poses_file: Optional[str] = None
    time_props: tuple = ("timestamp", "time", "t")

    def __post_init__(self):
        self.files = sorted(
            f for f in os.listdir(self.scan_dir) if f.endswith(".ply")
        )

    def __len__(self):
        return len(self.files)

    def _read(self, idx: int) -> np.ndarray:
        return read_ply(os.path.join(self.scan_dir, self.files[idx]))

    def scan(self, idx: int) -> np.ndarray:
        data = self._read(idx)
        return np.ascontiguousarray(
            np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
        )

    def scan_with_timestamps(self, idx: int):
        """(points (N,3), alphas (N,) in [0,1] or None)."""
        data = self._read(idx)
        pts = np.ascontiguousarray(
            np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
        )
        name = next((p for p in self.time_props if p in (data.dtype.names or ())), None)
        if name is None:
            return pts, None
        t = data[name].astype(np.float64)
        lo, hi = float(t.min()), float(t.max())
        alphas = np.zeros(len(t), np.float32) if hi <= lo else (
            (t - lo) / (hi - lo)
        ).astype(np.float32)
        return pts, alphas

    def ground_truth(self) -> Optional[np.ndarray]:
        if self.poses_file is None or not os.path.exists(self.poses_file):
            return None
        raw = np.loadtxt(self.poses_file, ndmin=2)
        flat = raw[:, 1:13] if raw.shape[1] >= 13 else raw[:, :12]
        poses = np.tile(np.eye(4), (len(flat), 1, 1))
        poses[:, :3, :4] = flat.reshape(-1, 3, 4)
        # rebase into the first frame like the other readers
        return np.einsum("ij,tjk->tik", np.linalg.inv(poses[0]), poses)


@dataclasses.dataclass
class KittiCarlaSequence:
    """KITTI-CARLA (CT-ICP layout): ``<root>/Town<NN>/frames/frame_*.ply``
    with per-point ``timestamp`` and a ``full_poses.txt`` GT log of
    timestamped 3×4 lidar poses (ref ``ct_icp_dataset.py:199-209`` sequence
    mapping; the reader itself lives in the external pyct_icp binary).

    GT per frame = pose row whose timestamp is nearest the frame's last
    point timestamp (end-of-sweep convention, matching the elastic odometry
    states).
    """

    root_dir: str
    town: int = 1

    def __post_init__(self):
        base = os.path.join(self.root_dir, f"Town{self.town:02d}")
        self._seq = PLYDirSequence(os.path.join(base, "frames"))
        self._poses_path = os.path.join(base, "full_poses.txt")

    def __len__(self):
        return len(self._seq)

    def scan(self, idx: int) -> np.ndarray:
        return self._seq.scan(idx)

    def scan_with_timestamps(self, idx: int):
        return self._seq.scan_with_timestamps(idx)

    def _frame_end_time(self, idx: int) -> float:
        data = self._seq._read(idx)
        names = data.dtype.names or ()
        return float(data["timestamp"].max()) if "timestamp" in names else float(idx)

    def ground_truth(self) -> Optional[np.ndarray]:
        if not os.path.exists(self._poses_path):
            return None
        raw = np.loadtxt(self._poses_path, ndmin=2)
        if raw.shape[1] >= 13:  # timestamped rows
            gt_times, flat = raw[:, 0], raw[:, 1:13]
        else:
            gt_times, flat = np.arange(len(raw), dtype=np.float64), raw[:, :12]
        poses = np.tile(np.eye(4), (len(flat), 1, 1))
        poses[:, :3, :4] = flat.reshape(-1, 3, 4)
        times = np.asarray([self._frame_end_time(i) for i in range(len(self))])
        hi = np.clip(np.searchsorted(gt_times, times), 0, len(gt_times) - 1)
        lo = np.maximum(hi - 1, 0)
        idx = np.where(
            np.abs(gt_times[hi] - times) <= np.abs(gt_times[lo] - times), hi, lo
        )
        sel = poses[idx]
        return np.einsum("ij,tjk->tik", np.linalg.inv(sel[0]), sel)
