"""The port's rosbag reader and writer (``data/rosbag.py``) against the
reference's, the cases of ``tests/test_rosbag.py``: PointCloud2 encoding and
decoding, bags of uncompressed and bz2 chunks (each writer's file the
other's byte for byte), the generic message decoder, bag-backed sequences
(frame accumulation, subsampling), UrbanLoco's INSPVAX ground truth and its
point-time models. The code is the same numpy and scipy: every output is
bit-equal. Bags are written under ``tmp_path`` from numpy seeds."""

import struct

import numpy as np
import pytest

from pwclonet_pylidarslam_torch.data import rosbag as trb
from pwclonet_pylidarslam_tpu.data import rosbag as jrb
from tools import dataset_files as df


def _make_bag(path, n_frames=4, topic="/velodyne_points", with_time=True,
              compression="none", n_points=300, impl=trb):
    rng = np.random.default_rng(0)
    messages, clouds = [], []
    for t in range(n_frames):
        pts = rng.uniform(-20, 20, (n_points, 3)).astype(np.float32)
        times = np.linspace(0, 1, n_points, endpoint=False) if with_time else None
        messages.append((topic, "sensor_msgs/PointCloud2",
                         impl.encode_pointcloud2(pts, times=times), 100.0 + t * 0.1))
        clouds.append(pts)
    impl.write_bag(str(path), messages, compression=compression)
    return clouds


def _make_urbanloco_bag(path, n_frames=6):
    """INSPVAX fixes at 10 Hz and scans at 5 Hz, heading north (azimuth 0)
    at 5 m a scan (the reference test's bag)."""
    rng = np.random.default_rng(1)
    lat0, lon0, alt0 = 22.3, 114.17, 10.0
    messages = []
    for k in range(2 * n_frames + 2):
        lat = lat0 + (2.5 * k) / 111132.9
        messages.append((trb.UrbanLocoSequence.GT_TOPIC, "novatel_msgs/INSPVAX",
                         df.encode_inspvax(lat, lon0, alt0, 0.0, 0.0, 0.0), 100.0 + k * 0.1))
    for f in range(n_frames):
        pts = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
        messages.append(("/velodyne_points", "sensor_msgs/PointCloud2",
                         trb.encode_pointcloud2(pts), 100.0 + f * 0.2))
    messages.sort(key=lambda m: m[3])
    trb.write_bag(str(path), messages, definitions={df.INSPVAX_TOPIC: df.INSPVAX_DEF})


def test_pointcloud2_roundtrip():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    times = np.linspace(0, 1, 10).astype(np.float32)
    raw = trb.encode_pointcloud2(pts, times=times)
    assert raw == jrb.encode_pointcloud2(pts, times=times)
    for got, want in zip(trb.decode_pointcloud2(raw), jrb.decode_pointcloud2(raw)):
        np.testing.assert_array_equal(got, want)
    dec, ts = trb.decode_pointcloud2(raw)
    np.testing.assert_array_equal(dec, pts)
    np.testing.assert_allclose(ts, times, atol=1e-6)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip(tmp_path, compression):
    clouds = _make_bag(tmp_path / "port.bag", compression=compression)
    _make_bag(tmp_path / "ref.bag", compression=compression, impl=jrb)
    assert (tmp_path / "port.bag").read_bytes() == (tmp_path / "ref.bag").read_bytes()
    msgs = list(trb.BagReader(tmp_path / "port.bag").read_messages(["/velodyne_points"]))
    assert msgs == list(jrb.BagReader(tmp_path / "port.bag").read_messages(["/velodyne_points"]))
    assert len(msgs) == 4 and abs(msgs[0][3] - 100.0) < 1e-6
    for (topic, mtype, raw, _), expect in zip(msgs, clouds):
        assert (topic, mtype) == ("/velodyne_points", "sensor_msgs/PointCloud2")
        np.testing.assert_array_equal(trb.decode_pointcloud2(raw)[0], expect)


def test_topic_filter_and_info(tmp_path):
    pts = np.ones((5, 3), np.float32)
    trb.write_bag(str(tmp_path / "two.bag"), [
        ("/a", "sensor_msgs/PointCloud2", trb.encode_pointcloud2(pts), 1.0),
        ("/b", "sensor_msgs/PointCloud2", trb.encode_pointcloud2(pts * 2), 2.0)])
    assert len(list(trb.BagReader(tmp_path / "two.bag").read_messages(["/b"]))) == 1
    info = trb.BagReader(tmp_path / "two.bag").topic_info()
    assert info == jrb.BagReader(tmp_path / "two.bag").topic_info()
    assert info == {"/a": "sensor_msgs/PointCloud2", "/b": "sensor_msgs/PointCloud2"}


def test_rejects_non_bag_and_unknown_chunks(tmp_path):
    (tmp_path / "x.bag").write_bytes(b"not a bag at all")
    with pytest.raises(ValueError):
        trb.BagReader(tmp_path / "x.bag")
    reader = trb.BagReader.__new__(trb.BagReader)
    with pytest.raises(ValueError, match="compression"):
        reader._decompress(b"zstd", b"")
    try:
        import lz4.frame  # noqa: F401
    except ImportError:  # as the reference: a bag of lz4 chunks needs lz4
        with pytest.raises(RuntimeError, match="lz4"):
            reader._decompress(b"lz4", b"")


def test_sequence_frames_accumulation_and_subsampling(tmp_path):
    clouds = _make_bag(tmp_path / "seq.bag", n_frames=6)
    kinds = [dict(), dict(frame_size=3), dict(num_points=128)]
    for kw in kinds:
        port = trb.RosbagSequence(str(tmp_path / "seq.bag"), "/velodyne_points", **kw)
        ref = jrb.RosbagSequence(str(tmp_path / "seq.bag"), "/velodyne_points", **kw)
        assert len(port) == len(ref)
        for i in (0, len(ref) - 1):  # a forward seek to the last frame
            np.testing.assert_array_equal(port.scan(i), ref.scan(i))
            np.testing.assert_array_equal(port.timestamps(i), ref.timestamps(i))
        assert port.ground_truth() is None
    seq = trb.RosbagSequence(str(tmp_path / "seq.bag"), "/velodyne_points")
    np.testing.assert_array_equal(seq.scan(3), clouds[3])
    assert 0.0 <= seq.timestamps(0).min() and seq.timestamps(0).max() <= 1.0
    assert trb.RosbagSequence(str(tmp_path / "seq.bag"), "/velodyne_points",
                              frame_size=3).scan(0).shape == (900, 3)
    assert trb.RosbagSequence(str(tmp_path / "seq.bag"), "/velodyne_points",
                              num_points=128).scan(0).shape == (128, 3)


def test_inspvax_and_nested_decode():
    raw = df.encode_inspvax(22.31, 114.18, 55.0, 1.5, -0.5, 90.0)
    msg = trb.decode_message(raw, df.INSPVAX_DEF)
    assert msg == jrb.decode_message(raw, df.INSPVAX_DEF)
    assert msg["header"]["frame_id"] == "gps" and msg["ins_status"] == 3
    assert [msg["latitude"], msg["longitude"], msg["altitude"]] == [22.31, 114.18, 55.0]
    assert [msg["roll"], msg["pitch"], msg["azimuth"]] == [1.5, -0.5, 90.0]
    defn = """\
uint8 KIND=3  # constant must be skipped
int16[3] fixed
float32[] var
Sub nested

================================================================================
MSG: pkg/Sub
uint32 value
string name
"""
    raw = struct.pack("<hhh", 1, -2, 3) + struct.pack("<I", 2) + struct.pack("<ff", 0.5, 1.5)
    raw += struct.pack("<I", 7) + struct.pack("<I", 2) + b"ab"
    msg = trb.decode_message(raw, defn)
    assert msg == jrb.decode_message(raw, defn)
    assert msg["fixed"] == [1, -2, 3] and msg["var"] == [0.5, 1.5]
    assert msg["nested"] == {"value": 7, "name": "ab"} and "KIND" not in msg
    assert trb.parse_message_definition(defn) == jrb.parse_message_definition(defn)


def test_urbanloco_ground_truth(tmp_path):
    """A northbound drive: +x (north, NWU) grows ~5 m a scan, the rotations
    stay the identity; bit-equal to the reference, and ``gps_poses`` is it."""
    _make_urbanloco_bag(tmp_path / "hk.bag", n_frames=6)
    port = trb.UrbanLocoSequence(str(tmp_path / "hk.bag"), trb.UrbanLocoSequence.HONG_KONG)
    ref = jrb.UrbanLocoSequence(str(tmp_path / "hk.bag"), jrb.UrbanLocoSequence.HONG_KONG)
    gt = port.ground_truth()
    np.testing.assert_array_equal(gt, ref.ground_truth())
    np.testing.assert_array_equal(port.gps_poses(), gt)
    assert gt.shape == (6, 4, 4)
    np.testing.assert_allclose(gt[:, :3, :3], np.tile(np.eye(3), (6, 1, 1)), atol=1e-6)
    np.testing.assert_allclose(np.diff(gt[:, 0, 3]), 5.0, rtol=0.02)
    np.testing.assert_allclose(gt[:, 1:3, 3], 0.0, atol=0.05)
    stamps, poses = port._inspvax_poses()
    for got, want in zip((stamps, poses), ref._inspvax_poses()):
        np.testing.assert_array_equal(got, want)
    q = np.array([100.05, 100.3, 200.0])
    np.testing.assert_array_equal(trb._interpolate_poses(stamps, poses, q),
                                  jrb._interpolate_poses(stamps, poses, q))
    lla = (114.17, 22.3, 10.0)
    np.testing.assert_array_equal(trb.lla_to_ecef(*lla), jrb.lla_to_ecef(*lla))
    np.testing.assert_array_equal(trb.ecef_to_enu(np.array(lla), trb.lla_to_ecef(114.2, 22.4, 3.0)),
                                  jrb.ecef_to_enu(np.array(lla), jrb.lla_to_ecef(114.2, 22.4, 3.0)))


def test_urbanloco_written_drive(tmp_path):
    """``tools/dataset_files.py``'s UrbanLoco bag (California, bz2 chunks, one
    fix a scan): the scans come back as written, the ground truth is the
    written poses rebased within 1e-6 m, bit-equal to the reference."""
    poses = np.tile(np.eye(4), (4, 1, 1))
    for t in range(4):
        c, s = np.cos(0.05 * t), np.sin(0.05 * t)
        poses[t, :2, :2] = [[c, -s], [s, c]]
        poses[t, :3, 3] = [3.0 * t, 0.4 * t * t, 0.02 * t]
    scans = [np.random.default_rng(t).uniform(-30, 30, (12 * 32 * 2, 3)).astype(np.float32)
             for t in range(4)]
    df.write_urbanloco(str(tmp_path / "CA-drive.bag"), scans, poses)
    port = trb.UrbanLocoSequence(str(tmp_path / "CA-drive.bag"), trb.UrbanLocoSequence.CALIFORNIA)
    ref = jrb.UrbanLocoSequence(str(tmp_path / "CA-drive.bag"), jrb.UrbanLocoSequence.CALIFORNIA)
    gt = port.ground_truth()
    np.testing.assert_array_equal(gt, ref.ground_truth())
    np.testing.assert_allclose(gt, df.expected_poses(poses), rtol=0, atol=1e-6)
    for t in range(4):
        np.testing.assert_array_equal(port.scan(t), scans[t])
        np.testing.assert_array_equal(port.timestamps(t), ref.timestamps(t))
    assert set(np.unique(port.timestamps(0)).tolist()) == {0.0, 1.0}


def test_urbanloco_point_times_and_acquisitions(tmp_path):
    _make_bag(tmp_path / "hk.bag", topic="/velodyne_points", with_time=False)
    port = trb.UrbanLocoSequence(str(tmp_path / "hk.bag"), trb.UrbanLocoSequence.HONG_KONG)
    ref = jrb.UrbanLocoSequence(str(tmp_path / "hk.bag"), jrb.UrbanLocoSequence.HONG_KONG)
    np.testing.assert_array_equal(port.timestamps(0), ref.timestamps(0))
    pc = port.scan(0)
    np.testing.assert_allclose(port.timestamps(0),
                               np.clip((np.pi - np.arctan2(pc[:, 1], pc[:, 0])) / (2 * np.pi), 0, 1))
    assert port.ground_truth() is None and ref.ground_truth() is None
    _make_bag(tmp_path / "ca.bag", topic="/rslidar_points", with_time=False,
              n_points=12 * 32 * 3)
    kw = dict(num_points=500)
    port = trb.UrbanLocoSequence(str(tmp_path / "ca.bag"), "california", **kw)
    ref = jrb.UrbanLocoSequence(str(tmp_path / "ca.bag"), "california", **kw)
    np.testing.assert_array_equal(port.scan(1), ref.scan(1))
    np.testing.assert_array_equal(port.timestamps(1), ref.timestamps(1))
    assert set(np.unique(port.timestamps(0)).tolist()) == {0.0, 0.5, 1.0}
    with pytest.raises(ValueError):
        trb.UrbanLocoSequence(str(tmp_path / "ca.bag"), "mars")
