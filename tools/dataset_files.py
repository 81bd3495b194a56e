"""Write sequences of scans and poses in the on-disk formats that the dataset
readers of ``pwclonet_pylidarslam_torch/data/`` read: a KITTI-360 drive, an
NCLT session, a Ford Campus sequence, an NHCD sequence, a PLY directory, a
KITTI-CARLA town, a rosbag of PointCloud2 messages and an UrbanLoco bag with
INSPVAX fixes.

Each writer takes scans in the sensor frame (``(N, 3)`` float32 each; rows of
zeros, a generator's padding, are dropped) and the sensor's absolute poses
``(T, 4, 4)`` in a world frame, and lays them out so that the reader gives
back the points (NCLT: up to its 5 mm packing) and the poses rebased to the
first frame. The tests and ``chip_smoke.py`` write their inputs with it.
Imports numpy and scipy only, and the port's bag encoder.

    python tools/dataset_files.py OUT_DIR   # a few corridor frames in every format
"""

from __future__ import annotations

import os
import struct
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwclonet_pylidarslam_torch.data.rosbag import (  # noqa: E402
    _ENU_TO_NWU,
    encode_pointcloud2,
    lla_to_ecef,
    write_bag,
)

# a KITTI-360-like camera→velodyne calibration: the camera axes (x right,
# y down, z forward) onto the velodyne's (x forward, y left, z up), with a
# lever arm, so that the readers' cam↔velo chains are not the identity
CAM_TO_VELO = np.array([[0.0, 0.0, 1.0, 0.81],
                        [-1.0, 0.0, 0.0, 0.32],
                        [0.0, -1.0, 0.0, -0.08],
                        [0.0, 0.0, 0.0, 1.0]])
NCLT_QUANTUM = 0.005  # m: the packed velodyne_sync records' step
NCLT_BOX = (-100.0, 65535 * NCLT_QUANTUM - 100.0)  # what a uint16 record can hold
# a decoded NCLT point against the written one: half a step, and float32's
# rounding of the decode (v * 0.005 - 100) within the box
NCLT_DECODE_ATOL = NCLT_QUANTUM / 2 + 3e-5
NCLT_T0_US = 1326030000000000
NHCD_T0_S = 1583836591
# a fix near the UrbanLoco California drives (lon, lat, alt)
URBANLOCO_ORIGIN = (-122.2624, 37.5300, 8.0)
INSPVAX_TOPIC = "/novatel_data/inspvax"
# novatel_msgs/INSPVAX as UrbanLoco bags embed it (the fields the readers use)
INSPVAX_DEF = """\
Header header
uint32 ins_status
uint32 position_type
float64 latitude
float64 longitude
float64 altitude
float32 undulation
float64 north_velocity
float64 east_velocity
float64 up_velocity
float64 roll
float64 pitch
float64 azimuth

================================================================================
MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id
"""


def valid_points(scan: np.ndarray) -> np.ndarray:
    """A scan without its all-zero rows, as float32."""
    scan = np.asarray(scan, np.float32)[:, :3]
    return scan[np.any(scan != 0.0, axis=-1)]


def expected_poses(poses: np.ndarray) -> np.ndarray:
    """What every reader returns as ground truth for ``poses``: the poses
    rebased to the first."""
    return np.linalg.inv(poses[0]) @ np.asarray(poses, np.float64)


def write_kitti360(root: str, sequence: int, scans: Sequence[np.ndarray], poses: np.ndarray,
                   cam_to_velo: np.ndarray = CAM_TO_VELO) -> None:
    """``data_3d_raw/<drive>/velodyne_points/data/*.bin`` (x, y, z and an
    intensity of 1), ``data_poses/<drive>/poses.txt`` (every frame's cam0
    pose) and ``calibration/calib_cam_to_velo.txt``."""
    drive = f"2013_05_28_drive_{sequence:04d}_sync"
    velo = Path(root, "data_3d_raw", drive, "velodyne_points", "data")
    velo.mkdir(parents=True, exist_ok=True)
    for t, scan in enumerate(scans):
        pts = valid_points(scan)
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)], -1).tofile(
            velo / f"{t:010d}.bin")
    cam = np.asarray(poses, np.float64) @ cam_to_velo  # velo pose = cam pose @ velo_to_cam
    rows = np.concatenate([np.arange(len(cam))[:, None], cam[:, :3, :4].reshape(-1, 12)], 1)
    pose_dir = Path(root, "data_poses", drive)
    pose_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(pose_dir / "poses.txt", rows)
    calib = Path(root, "calibration")
    calib.mkdir(parents=True, exist_ok=True)
    np.savetxt(calib / "calib_cam_to_velo.txt", cam_to_velo[:3].reshape(1, 12))


def nclt_packable(scan: np.ndarray) -> np.ndarray:
    """The points of a scan that a packed NCLT record can hold."""
    pts = valid_points(scan)
    return pts[np.all((pts >= NCLT_BOX[0]) & (pts <= NCLT_BOX[1]), axis=-1)]


def write_nclt(root: str, session: str, scans: Sequence[np.ndarray], poses: np.ndarray,
               period_us: int = 100_000) -> List[np.ndarray]:
    """``<session>/velodyne_sync/<utime>.bin`` (x, y, z as uint16 steps of
    5 mm from -100 m, and a zero word) and ``groundtruth_<session>.csv``
    (utime, x, y, z, roll, pitch, yaw) at the scans' times. Returns the
    points written (the packable ones)."""
    vdir = Path(root, session, "velodyne_sync")
    vdir.mkdir(parents=True, exist_ok=True)
    written, utimes = [], []
    for t, scan in enumerate(scans):
        pts = nclt_packable(scan)
        packed = np.round((pts.astype(np.float64) + 100.0) / NCLT_QUANTUM).astype(np.uint16)
        rec = np.concatenate([packed, np.zeros((len(pts), 1), np.uint16)], -1)
        utime = NCLT_T0_US + t * period_us
        rec.tofile(vdir / f"{utime}.bin")
        written.append(pts)
        utimes.append(utime)
    poses = np.asarray(poses, np.float64)
    rpy = Rotation.from_matrix(poses[:, :3, :3]).as_euler("xyz")
    rows = np.concatenate([np.asarray(utimes, np.float64)[:, None], poses[:, :3, 3], rpy], 1)
    np.savetxt(Path(root, session, f"groundtruth_{session}.csv"), rows, delimiter=",")
    return written


def write_ford(sequence_dir: str, scans: Sequence[np.ndarray], poses: np.ndarray) -> None:
    """``SCANS/Scan<NNNN>.mat``, each a ``SCAN`` struct of ``XYZ`` (3, N)
    and ``X_wv`` (x, y, z, roll, pitch, yaw)."""
    from scipy.io import savemat

    scan_dir = Path(sequence_dir, "SCANS")
    scan_dir.mkdir(parents=True, exist_ok=True)
    poses = np.asarray(poses, np.float64)
    rpy = Rotation.from_matrix(poses[:, :3, :3]).as_euler("xyz")
    for t, scan in enumerate(scans):
        x_wv = np.concatenate([poses[t, :3, 3], rpy[t]])
        savemat(scan_dir / f"Scan{t + 1:04d}.mat",
                {"SCAN": {"XYZ": valid_points(scan).T, "X_wv": x_wv}})


def _ply_fields(pts: np.ndarray, times: Optional[np.ndarray]) -> np.ndarray:
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if times is not None:
        fields.append(("timestamp", "<f8"))
    data = np.zeros(len(pts), dtype=np.dtype(fields))
    for k, name in enumerate("xyz"):
        data[name] = pts[:, k]
    if times is not None:
        data["timestamp"] = times
    return data


def write_nhcd(root: str, sequence: str, scans: Sequence[np.ndarray], poses: np.ndarray,
               period_ns: int = 100_000_000) -> None:
    """``<sequence>/raw_format/ouster_scan/cloud_<sec>_<nsec>.ply`` and
    ``ground_truth/registered_poses.csv`` (sec, nsec, x, y, z, qx, qy, qz, qw)
    at the scans' times."""
    from pwclonet_pylidarslam_torch.data.other_datasets import write_ply

    scan_dir = Path(root, sequence, "raw_format", "ouster_scan")
    scan_dir.mkdir(parents=True, exist_ok=True)
    stamps = []
    for t, scan in enumerate(scans):
        ns = t * period_ns
        sec, nsec = NHCD_T0_S + ns // 1_000_000_000, ns % 1_000_000_000
        write_ply(str(scan_dir / f"cloud_{sec}_{nsec:09d}.ply"),
                  _ply_fields(valid_points(scan), None))
        stamps.append((sec, nsec))
    poses = np.asarray(poses, np.float64)
    rows = np.concatenate([np.asarray(stamps, np.float64), poses[:, :3, 3],
                           Rotation.from_matrix(poses[:, :3, :3]).as_quat()], 1)
    gt_dir = Path(root, sequence, "ground_truth")
    gt_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(gt_dir / "registered_poses.csv", rows, delimiter=",",
               header="sec,nsec,x,y,z,qx,qy,qz,qw")


def write_ply_dir(scan_dir: str, scans: Sequence[np.ndarray], poses: np.ndarray,
                  times: Optional[Sequence[np.ndarray]] = None) -> None:
    """``frame_<NNNN>.ply`` frames (with a per-point ``timestamp``, the
    fraction of the sweep, where ``times`` is given) and KITTI-style 12-float pose rows in ``poses.txt``
    beside the directory."""
    from pwclonet_pylidarslam_torch.data.other_datasets import write_ply

    Path(scan_dir).mkdir(parents=True, exist_ok=True)
    for t, scan in enumerate(scans):
        pts = valid_points(scan)
        ts = None if times is None else sweep_times(scan, times[t], t, t0=0.0, period=1.0) - t
        write_ply(os.path.join(scan_dir, f"frame_{t:04d}.ply"), _ply_fields(pts, ts))
    np.savetxt(Path(scan_dir).parent / "poses.txt",
               np.asarray(poses, np.float64)[:, :3, :4].reshape(-1, 12))


def sweep_times(scan: np.ndarray, alphas: np.ndarray, t: int, t0: float = 10.0,
                period: float = 0.1) -> np.ndarray:
    """Per-point absolute times of frame ``t`` of a sweep of ``period``
    seconds, from its points' fractions of the sweep."""
    keep = np.any(np.asarray(scan)[:, :3] != 0.0, axis=-1)
    return t0 + t * period + period * np.asarray(alphas, np.float64)[keep]


def write_kitti_carla(root: str, town: int, scans: Sequence[np.ndarray], poses: np.ndarray,
                      alphas: Sequence[np.ndarray], t0: float = 10.0,
                      period: float = 0.1) -> None:
    """``Town<NN>/frames/frame_<NNNN>.ply`` with a per-point ``timestamp``
    and ``full_poses.txt`` (timestamp and 12 pose floats), each pose stamped
    at its frame's last point, the time the reader matches it at."""
    from pwclonet_pylidarslam_torch.data.other_datasets import write_ply

    frames = Path(root, f"Town{town:02d}", "frames")
    frames.mkdir(parents=True, exist_ok=True)
    ends = []
    for t, scan in enumerate(scans):
        ts = sweep_times(scan, alphas[t], t, t0, period)
        write_ply(str(frames / f"frame_{t:04d}.ply"), _ply_fields(valid_points(scan), ts))
        ends.append(ts.max())
    rows = np.concatenate([np.asarray(ends)[:, None],
                           np.asarray(poses, np.float64)[:, :3, :4].reshape(-1, 12)], 1)
    np.savetxt(frames.parent / "full_poses.txt", rows)


def write_rosbag(path: str, scans: Sequence[np.ndarray], topic: str = "/velodyne_points",
                 alphas: Optional[Sequence[np.ndarray]] = None, compression: str = "none",
                 t0: float = 100.0, period: float = 0.1, extra: Sequence[tuple] = (),
                 definitions: Optional[dict] = None) -> None:
    """One PointCloud2 message a scan on ``topic`` (with a per-point
    ``time`` field where ``alphas`` is given), ``extra`` messages
    ``(topic, type, raw, t)`` merged in time order."""
    messages = list(extra)
    for t, scan in enumerate(scans):
        keep = np.any(np.asarray(scan)[:, :3] != 0.0, axis=-1)
        times = None if alphas is None else np.asarray(alphas[t])[keep]
        messages.append((topic, "sensor_msgs/PointCloud2",
                         encode_pointcloud2(valid_points(scan), times=times), t0 + t * period))
    messages.sort(key=lambda m: m[3])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_bag(path, messages, compression=compression, definitions=definitions)


def ecef_to_lla(ecef: np.ndarray) -> np.ndarray:
    """ECEF → (lon, lat, alt) degrees on the ellipsoid of the readers'
    ``lla_to_ecef`` (fixed-point iteration on the latitude)."""
    a, b = 6378137.0, 6356752.314
    e2 = 1.0 - b * b / (a * a)
    x, y, z = ecef
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - e2))
    for _ in range(20):
        n = a * a / np.sqrt(a * a * np.cos(lat) ** 2 + b * b * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - e2 * n / (n + alt)))
    n = a * a / np.sqrt(a * a * np.cos(lat) ** 2 + b * b * np.sin(lat) ** 2)
    return np.array([np.rad2deg(lon), np.rad2deg(lat), p / np.cos(lat) - n])


def enu_to_lla(origin_lla: Sequence[float], enu: np.ndarray) -> np.ndarray:
    """Local East/North/Up at ``origin_lla`` → (lon, lat, alt) degrees."""
    lon, lat = np.deg2rad(origin_lla[0]), np.deg2rad(origin_lla[1])
    sl, cl, sp, cp = np.sin(lon), np.cos(lon), np.sin(lat), np.cos(lat)
    # the transpose of the readers' ecef_to_enu rotation
    rot = np.array([[-sl, cl, 0.0], [-sp * cl, -sp * sl, cp], [cp * cl, cp * sl, sp]])
    return ecef_to_lla(lla_to_ecef(*origin_lla) + rot.T @ enu)


def encode_inspvax(lat: float, lon: float, alt: float, roll: float, pitch: float,
                   azimuth: float) -> bytes:
    out = bytearray()
    out += struct.pack("<I", 0)  # header.seq
    out += struct.pack("<II", 0, 0)  # header.stamp
    out += struct.pack("<I", 3) + b"gps"  # header.frame_id
    out += struct.pack("<II", 3, 56)  # ins_status, position_type
    out += struct.pack("<ddd", lat, lon, alt)
    out += struct.pack("<f", 0.0)  # undulation
    out += struct.pack("<ddd", 0.0, 0.0, 0.0)  # velocities
    out += struct.pack("<ddd", roll, pitch, azimuth)
    return bytes(out)


def inspvax_messages(poses: np.ndarray, stamps: Sequence[float],
                     origin_lla: Sequence[float] = URBANLOCO_ORIGIN) -> List[tuple]:
    """One INSPVAX fix a pose: the world frame read as North-West-Up at
    ``origin_lla``, the reader's conventions inverted (ENU position through
    ECEF to latitude, longitude, altitude; azimuth clockwise from north)."""
    enu_of_nwu = np.linalg.inv(_ENU_TO_NWU)
    out = []
    for pose, t in zip(np.asarray(poses, np.float64), stamps):
        enu = enu_of_nwu @ pose @ _ENU_TO_NWU
        lon, lat, alt = enu_to_lla(origin_lla, enu[:3, 3])
        neg_yaw, pitch, roll = Rotation.from_matrix(enu[:3, :3]).as_euler("zyx", degrees=True)
        out.append((INSPVAX_TOPIC, "novatel_msgs/INSPVAX",
                    encode_inspvax(lat, lon, alt, roll, pitch, -neg_yaw), float(t)))
    return out


def write_urbanloco(path: str, scans: Sequence[np.ndarray], poses: np.ndarray,
                    california: bool = True, compression: str = "bz2",
                    t0: float = 100.0, period: float = 0.1) -> None:
    """An UrbanLoco bag: the scans on ``/rslidar_points`` (California) or
    ``/velodyne_points`` (Hong Kong) and one INSPVAX fix a scan at its time
    (the GPS/INS stream the readers take the ground truth and the GPS priors
    from)."""
    stamps = [t0 + t * period for t in range(len(scans))]
    write_rosbag(path, scans, topic="/rslidar_points" if california else "/velodyne_points",
                 compression=compression, t0=t0, period=period,
                 extra=inspvax_messages(poses, stamps),
                 definitions={INSPVAX_TOPIC: INSPVAX_DEF})


def write_all(root: str, scans: Sequence[np.ndarray], poses: np.ndarray,
              alphas: Sequence[np.ndarray], urbanloco_frames: Optional[int] = None) -> dict:
    """Every format under ``root`` (the UrbanLoco bag with the first
    ``urbanloco_frames`` frames, all by default); returns, for each
    ``run_slam_torch.py`` dataset, its ``root_dir`` under ``root`` and its
    ``sequences``."""
    n_ul = len(scans) if urbanloco_frames is None else urbanloco_frames
    write_kitti360(os.path.join(root, "kitti360"), 0, scans, poses)
    write_nclt(os.path.join(root, "nclt"), "2012-01-08", scans, poses)
    write_ford(os.path.join(root, "ford", "dataset-1"), scans, poses)
    write_nhcd(os.path.join(root, "nhcd"), "01_short_experiment", scans, poses)
    write_ply_dir(os.path.join(root, "ply", "frames"), scans, poses, alphas)
    write_kitti_carla(os.path.join(root, "kitti_carla"), 1, scans, poses, alphas)
    write_rosbag(os.path.join(root, "bags", "drive.bag"), scans, alphas=alphas)
    write_urbanloco(os.path.join(root, "bags", "CA-drive.bag"), scans[:n_ul], poses[:n_ul])
    return {
        "kitti360": ("kitti360", "0"), "nclt": ("nclt", "2012-01-08"),
        "ford": ("ford", "dataset-1"), "nhcd": ("nhcd", "01_short_experiment"),
        "ply_dir": ("ply", "frames"), "kitti_carla": ("kitti_carla", "1"),
        "rosbag": ("bags", "drive.bag"), "urbanloco": ("bags", "CA-drive.bag"),
    }


if __name__ == "__main__":
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence_with_times,
    )

    if len(sys.argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    scans, alphas, poses = generate_sequence_with_times(
        SyntheticSequenceConfig(n_frames=4, num_points=2048), device="cpu")
    for name, (sub, seq) in write_all(sys.argv[1], scans, poses, alphas).items():
        print(f"dataset={name} root_dir={os.path.join(sys.argv[1], sub)} sequences={seq}")
