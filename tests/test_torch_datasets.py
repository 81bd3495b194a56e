"""The port's dataset readers (``data/other_datasets.py``) against the
reference's on the same files, written under ``tmp_path`` from numpy seeds:
the cases of ``tests/test_other_datasets.py`` and ``tests/test_ply_datasets.py``
and a corridor sequence in every format (``tools/dataset_files.py``). The
code is the same numpy, so scans, ground truth and timestamps, PLY round
trips and the KITTI-360 training pairs' clouds are bit-equal; a pair's
``gt_params`` goes through torch's quaternion (the reference's through jnp)
and is held at 1e-6. Then the ``dataset=kitti360`` wiring of
``train_net_torch.py`` against ``train_net.py``'s."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from pwclonet_pylidarslam_torch.data import other_datasets as tod
from pwclonet_pylidarslam_torch.data.synthetic import (
    SyntheticSequenceConfig,
    generate_sequence_with_times,
)
from pwclonet_pylidarslam_tpu.data import other_datasets as jod
from tools import dataset_files as df

GT_PARAMS_ATOL = 1e-6  # the quaternion: torch float64 here, jnp float64 there


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor():
    """Four corridor frames of 2048 points with their sweep fractions and
    poses, from the port's generator on the CPU."""
    scans, alphas, poses = generate_sequence_with_times(
        SyntheticSequenceConfig(n_frames=4, num_points=2048, seed=3), device="cpu")
    return scans.astype(np.float32), alphas.astype(np.float32), poses


def assert_same_source(port, ref, timestamps=False):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        np.testing.assert_array_equal(port.scan(i), ref.scan(i))
        if timestamps:
            for a, b in zip(port.scan_with_timestamps(i), ref.scan_with_timestamps(i)):
                np.testing.assert_array_equal(a, b)
    gt_port, gt_ref = port.ground_truth(), ref.ground_truth()
    if gt_ref is None:
        assert gt_port is None
    else:
        np.testing.assert_array_equal(gt_port, gt_ref)
    return gt_port


def _kitti360_files(tmp_path, seq, n_frames, n_points, seed, moving_world):
    drive = tod.kitti360_drive_name(seq)
    velo = tmp_path / "data_3d_raw" / drive / "velodyne_points" / "data"
    velo.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    world = np.concatenate(
        [rng.uniform(-20, 20, (n_points, 2)), rng.uniform(-1.0, 1.0, (n_points, 1))], -1)
    rows = []
    for t in range(n_frames):
        pose = np.eye(4)
        pose[0, 3] = 1.2 * t
        pts = world if not moving_world else (np.linalg.inv(pose) @ np.concatenate(
            [world, np.ones((n_points, 1))], -1).T).T[:, :3]
        np.concatenate([pts, np.ones((n_points, 1))], -1).astype(np.float32).tofile(
            velo / f"{t:010d}.bin")
        rows.append(np.concatenate([[t], pose[:3, :4].reshape(-1)]))
    poses_dir = tmp_path / "data_poses" / drive
    poses_dir.mkdir(parents=True)
    np.savetxt(poses_dir / "poses.txt", np.stack(rows))
    (tmp_path / "calibration").mkdir()
    np.savetxt(tmp_path / "calibration" / "calib_cam_to_velo.txt",
               np.eye(4)[:3].reshape(-1)[None])
    return world


def test_kitti360_sequence(tmp_path):
    drive = tod.kitti360_drive_name(0)
    velo = tmp_path / "data_3d_raw" / drive / "velodyne_points" / "data"
    velo.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(4):
        np.concatenate([rng.normal(size=(100, 3)), np.ones((100, 1))], -1).astype(
            np.float32).tofile(velo / f"{t:010d}.bin")
    poses_dir = tmp_path / "data_poses" / drive
    poses_dir.mkdir(parents=True)
    rows = []
    for t in (0, 2):  # sparse GT like the real dataset
        pose = np.eye(4)
        pose[0, 3] = 2.0 * t
        rows.append(np.concatenate([[t], pose[:3, :4].reshape(-1)]))
    np.savetxt(poses_dir / "poses.txt", np.stack(rows))
    (tmp_path / "calibration").mkdir()
    np.savetxt(tmp_path / "calibration" / "calib_cam_to_velo.txt",
               np.eye(4)[:3].reshape(-1)[None])
    gt = assert_same_source(tod.Kitti360Sequence(str(tmp_path), 0),
                            jod.Kitti360Sequence(str(tmp_path), 0))
    assert gt.shape == (4, 4, 4) and gt[2][0, 3] == 4.0
    np.testing.assert_array_equal(tod.Kitti360Sequence(str(tmp_path), 0).cam_to_velo, np.eye(4))


def test_nclt_decode_and_sequence(tmp_path):
    xyz = np.array([[1.5, -2.0, 0.25], [10.0, 20.0, -1.0]], np.float32)
    packed = np.round((xyz + 100.0) / 0.005).astype(np.uint16)
    rec = np.concatenate([packed, np.zeros((2, 1), np.uint16)], -1)
    np.testing.assert_array_equal(tod.nclt_decode_scan(rec.reshape(-1)),
                                  jod.nclt_decode_scan(rec.reshape(-1)))
    sess = "2012-01-08"
    vdir = tmp_path / sess / "velodyne_sync"
    vdir.mkdir(parents=True)
    rec.tofile(vdir / "1326030000000000.bin")
    rec.tofile(vdir / "1326030000100000.bin")
    gt = np.zeros((3, 7))
    gt[:, 0] = [1326029999000000, 1326030000000000, 1326030000200000]
    gt[:, 1] = [0.0, 1.0, 2.0]
    np.savetxt(tmp_path / sess / f"groundtruth_{sess}.csv", gt, delimiter=",")
    port = tod.NCLTSequence(str(tmp_path), sess)
    poses = assert_same_source(port, jod.NCLTSequence(str(tmp_path), sess))
    np.testing.assert_allclose(port.scan(0), xyz, atol=0.005)
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-9)
    assert port.scan_timestamp(1) == 1326030000100000.0


def test_nhcd_ply_and_gt(tmp_path):
    scan_dir = tmp_path / "01_short" / "raw_format" / "ouster_scan"
    scan_dir.mkdir(parents=True)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 50\n"
              b"property float x\nproperty float y\nproperty float z\nend_header\n")
    for name in ("cloud_1000_000000000.ply", "cloud_1001_000000000.ply"):
        with open(scan_dir / name, "wb") as f:
            f.write(header)
            f.write(pts.astype("<f4").tobytes())
    gt_dir = tmp_path / "01_short" / "ground_truth"
    gt_dir.mkdir(parents=True)
    rows = np.zeros((2, 9))
    rows[:, 0] = [1000, 1001]
    rows[:, 2] = [0.0, 1.0]
    rows[:, 5:9] = R.from_rotvec([[0, 0, 0.0], [0, 0, 0.1]]).as_quat()
    np.savetxt(gt_dir / "registered_poses.csv", rows, delimiter=",",
               header="sec,nsec,x,y,z,qx,qy,qz,qw")
    port = tod.NHCDSequence(str(tmp_path), "01_short")
    gt = assert_same_source(port, jod.NHCDSequence(str(tmp_path), "01_short"))
    np.testing.assert_array_equal(port.scan(0), pts)
    np.testing.assert_allclose(gt[1][0, 3], 1.0, atol=1e-9)


def test_ply_ascii_variant(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\nend_header\n"
                    "1.0 2.0 3.0\n4.0 5.0 6.0\n")
    pts = tod.read_ply_xyz(str(path))
    np.testing.assert_array_equal(pts, jod.read_ply_xyz(str(path)))
    np.testing.assert_array_equal(pts, [[1, 2, 3], [4, 5, 6]])


def test_ford_sequence(tmp_path):
    from scipy.io import savemat

    scan_dir = tmp_path / "SCANS"
    scan_dir.mkdir()
    rng = np.random.default_rng(2)
    for t in range(2):
        savemat(scan_dir / f"Scan{t:04d}.mat",
                {"SCAN": {"XYZ": rng.normal(size=(3, 40)),
                          "X_wv": np.array([t * 1.0, 0, 0, 0, 0, 0])}})
    port = tod.FordCampusSequence(str(tmp_path))
    gt = assert_same_source(port, jod.FordCampusSequence(str(tmp_path)))
    assert port.scan(0).shape == (40, 3) and gt[1][0, 3] == 1.0


def _cloud(rng, n=100, with_time=True, with_label=False):
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if with_time:
        fields.append(("timestamp", "<f8"))
    if with_label:
        fields.append(("semantic", "<u4"))
    data = np.zeros(n, dtype=np.dtype(fields))
    for name in "xyz":
        data[name] = rng.normal(size=n)
    if with_time:
        data["timestamp"] = np.sort(rng.uniform(10.0, 10.1, size=n))
    if with_label:
        data["semantic"] = rng.integers(0, 20, size=n)
    return data


def test_ply_roundtrip_across_implementations(tmp_path, rng):
    """Each writer's file is the other's byte for byte, and each reader
    reads either back to the written fields."""
    data = _cloud(rng, with_label=True)
    tod.write_ply(str(tmp_path / "port.ply"), data)
    jod.write_ply(str(tmp_path / "ref.ply"), data)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    back = tod.read_ply(str(tmp_path / "ref.ply"))
    assert back.dtype == jod.read_ply(str(tmp_path / "port.ply")).dtype
    assert back.dtype.names == data.dtype.names
    for name in data.dtype.names:
        np.testing.assert_array_equal(back[name], data[name])
    np.testing.assert_array_equal(tod.read_ply_xyz(str(tmp_path / "port.ply")),
                                  jod.read_ply_xyz(str(tmp_path / "port.ply")))


def test_ply_dir_sequence(tmp_path, rng):
    scan_dir = tmp_path / "frames"
    scan_dir.mkdir()
    clouds = [_cloud(rng) for _ in range(3)]
    for i, c in enumerate(clouds):
        tod.write_ply(str(scan_dir / f"frame_{i:04d}.ply"), c)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, 0, 3] = [0.0, 1.0, 2.0]
    np.savetxt(str(tmp_path / "poses.txt"), poses[:, :3, :4].reshape(3, 12))
    port = tod.PLYDirSequence(str(scan_dir), str(tmp_path / "poses.txt"))
    gt = assert_same_source(port, jod.PLYDirSequence(str(scan_dir), str(tmp_path / "poses.txt")),
                            timestamps=True)
    _, alphas = port.scan_with_timestamps(2)
    assert alphas.min() == 0.0 and alphas.max() == 1.0 and gt[2, 0, 3] == 2.0
    assert tod.PLYDirSequence(str(scan_dir)).ground_truth() is None


def test_kitti_carla_nearest_timestamp_gt(tmp_path, rng):
    town = tmp_path / "Town03"
    frames = town / "frames"
    frames.mkdir(parents=True)
    for i, t0 in enumerate((10.0, 20.0)):
        c = _cloud(rng, n=50)
        c["timestamp"] = np.linspace(t0, t0 + 0.1, 50)
        tod.write_ply(str(frames / f"frame_{i:04d}.ply"), c)
    times = np.arange(9.9, 20.6, 0.2)
    poses = np.tile(np.eye(4), (len(times), 1, 1))
    poses[:, 1, 3] = times
    np.savetxt(str(town / "full_poses.txt"),
               np.concatenate([times[:, None], poses[:, :3, :4].reshape(-1, 12)], axis=1))
    gt = assert_same_source(tod.KittiCarlaSequence(str(tmp_path), town=3),
                            jod.KittiCarlaSequence(str(tmp_path), town=3), timestamps=True)
    assert abs(gt[1, 1, 3] - 10.0) < 0.21


def test_every_format_of_one_sequence(tmp_path, corridor):
    """A corridor sequence written in every format: both implementations read
    the same scans, timestamps and ground truth, which are what was written
    (NCLT up to its 5 mm packing) and the poses rebased to frame 0."""
    scans, alphas, poses = corridor
    root = str(tmp_path)
    df.write_all(root, scans, poses, alphas)
    want = df.expected_poses(poses)
    pairs = {
        "kitti360": (tod.Kitti360Sequence(f"{root}/kitti360", 0),
                     jod.Kitti360Sequence(f"{root}/kitti360", 0)),
        "nclt": (tod.NCLTSequence(f"{root}/nclt", "2012-01-08"),
                 jod.NCLTSequence(f"{root}/nclt", "2012-01-08")),
        "ford": (tod.FordCampusSequence(f"{root}/ford/dataset-1"),
                 jod.FordCampusSequence(f"{root}/ford/dataset-1")),
        "nhcd": (tod.NHCDSequence(f"{root}/nhcd", "01_short_experiment"),
                 jod.NHCDSequence(f"{root}/nhcd", "01_short_experiment")),
        "ply_dir": (tod.PLYDirSequence(f"{root}/ply/frames", f"{root}/ply/poses.txt"),
                    jod.PLYDirSequence(f"{root}/ply/frames", f"{root}/ply/poses.txt")),
        "kitti_carla": (tod.KittiCarlaSequence(f"{root}/kitti_carla", 1),
                        jod.KittiCarlaSequence(f"{root}/kitti_carla", 1)),
    }
    for name, (port, ref) in pairs.items():
        gt = assert_same_source(port, ref, timestamps=name in ("ply_dir", "kitti_carla"))
        np.testing.assert_allclose(gt, want, atol=1e-9, err_msg=name)
        for t in range(len(scans)):
            if name == "nclt":
                np.testing.assert_allclose(port.scan(t), df.nclt_packable(scans[t]),
                                           atol=df.NCLT_DECODE_ATOL)
            else:
                np.testing.assert_array_equal(port.scan(t), df.valid_points(scans[t]),
                                              err_msg=name)
    _, sweep = pairs["kitti_carla"][0].scan_with_timestamps(1)
    assert sweep.min() == 0.0 and sweep.max() == 1.0


def test_kitti360_pair_dataset(tmp_path):
    """The clouds of every item bit-equal to the reference's, ``gt_params``
    within 1e-6; the ground-truth warp closes the current cloud onto the
    previous frame's world points (the reference test's check); batches."""
    world = _kitti360_files(tmp_path, 3, 4, 3000, 5, moving_world=True)
    port = tod.Kitti360PairDataset(str(tmp_path), (3,), num_points=512, seed=0)
    ref = jod.Kitti360PairDataset(str(tmp_path), (3,), num_points=512, seed=0)
    assert len(port) == len(ref) == 4
    items = [port[i] for i in range(4)]
    for a, b in zip(items, (ref[i] for i in range(4))):
        np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
        np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
        assert a["gt_params"].dtype == np.float32
        np.testing.assert_allclose(a["gt_params"], b["gt_params"], rtol=0, atol=GT_PARAMS_ATOL)
    item = items[2]
    q = item["gt_params"][3:].astype(np.float64)
    pose = np.eye(4)
    pose[:3, :3] = R.from_quat(np.roll(q, -1)).as_matrix()
    pose[:3, 3] = item["gt_params"][:3]
    warped = (pose[:3, :3] @ item["xyz1"].astype(np.float64).T).T + pose[:3, 3]
    prev = world - np.array([1.2, 0.0, 0.0])
    assert np.median(np.sqrt(((warped[:, None] - prev[None]) ** 2).sum(-1)).min(1)) < 1e-3
    bp, br = next(port.batches(2)), next(ref.batches(2))
    assert bp["xyz1"].shape == (2, 512, 3)
    np.testing.assert_array_equal(bp["xyz2"], br["xyz2"])


def test_kitti360_pair_dataset_augmented_and_calibrated(tmp_path, corridor):
    """With the SE(3) augmentation and a calibration that is not the
    identity (``tools/dataset_files.py``), over a frame gap of up to 2."""
    scans, alphas, poses = corridor
    df.write_kitti360(str(tmp_path), 1, scans, poses)
    kw = dict(num_points=256, max_frame_gap=2, augment=True, seed=4)
    port = tod.Kitti360PairDataset(str(tmp_path), (1,), **kw)
    ref = jod.Kitti360PairDataset(str(tmp_path), (1,), **kw)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
        np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
        np.testing.assert_allclose(a["gt_params"], b["gt_params"], rtol=0, atol=GT_PARAMS_ATOL)


def test_train_net_kitti360_wiring(tmp_path):
    """``make_batch_fns`` and ``make_test_sequence`` with dataset=kitti360:
    the reference's batches (clouds bit-equal, ``gt_params`` within 1e-6)
    and sequence (ref train.py:337-345 builds Kitti360Dataset for the same
    recipe)."""
    import train_net
    import train_net_torch

    _kitti360_files(tmp_path, 3, 5, 2000, 5, moving_world=False)
    kw = dict(dataset="kitti360", root_dir=str(tmp_path), train_sequences="3",
              eval_sequences="3", num_points=256, batch_size=2)
    port_fns = train_net_torch.make_batch_fns(train_net_torch.Config(**kw, device="cpu"))
    ref_fns = train_net.make_batch_fns(train_net.Config(**kw), None)
    for port_fn, ref_fn in zip(port_fns, ref_fns):
        for a, b in zip(port_fn(), ref_fn()):
            assert a["xyz1"].shape == (2, 256, 3) and a["gt_params"].shape == (2, 7)
            np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
            np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
            np.testing.assert_allclose(a["gt_params"], b["gt_params"], rtol=0,
                                       atol=GT_PARAMS_ATOL)
    seq = train_net_torch.make_test_sequence(train_net_torch.Config(**kw), 3)
    assert isinstance(seq, tod.Kitti360Sequence)
    assert_same_source(seq, train_net.make_test_sequence(train_net.Config(**kw), 3))
