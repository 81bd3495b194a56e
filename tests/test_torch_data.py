"""The port's numpy copies: ``evaluation/metrics.py`` and the synthetic
sequence generator, against the JAX package's originals."""

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.data import synthetic as tsyn
from pwclonet_pylidarslam_torch.evaluation import metrics as tmet
from pwclonet_pylidarslam_tpu.data import synthetic as jsyn
from pwclonet_pylidarslam_tpu.evaluation import metrics as jmet


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread (the synthetic caster's among
    them): with several test workers on one machine, torch's thread pool
    per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(gt, rng, sigma_t=0.02, sigma_r=0.002):
    """GT with seeded noise on every relative pose, re-chained."""
    rel = jmet.compute_relative_poses(gt)
    for t in range(1, len(rel)):
        w = rng.normal(size=3) * sigma_r
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        rel[t, :3, :3] = rel[t, :3, :3] @ (np.eye(3) + k + 0.5 * k @ k)
        rel[t, :3, 3] += rng.normal(size=3) * sigma_t
    return gt[0] @ jmet.compute_absolute_poses(rel)


@pytest.mark.parametrize("mode", jmet.EVAL_MODES)
def test_metrics_equal_reference(rng, mode):
    gt = jsyn.make_trajectory("curve", 150, 1.0, 0.5)
    pred = _noisy(gt, rng)
    ours = tmet.metrics_dict(pred, gt, nsecs_per_frame=0.05, mode=mode)
    ref = jmet.metrics_dict(pred, gt, nsecs_per_frame=0.05, mode=mode)
    assert ours == ref
    assert np.isfinite(ours["tr_err"])  # the 149 m path holds 100 m segments
    tr, rot, errors = tmet.compute_kitti_metrics(pred, gt)
    assert (tr, rot, errors) == jmet.compute_kitti_metrics(pred, gt)
    assert errors


def test_lidar_directions_and_trajectories_identical():
    np.testing.assert_array_equal(tsyn.lidar_directions(16, 90), jsyn.lidar_directions(16, 90))
    for kind in ("straight", "curve", "circle", "kitti_drive", "there_and_back"):
        np.testing.assert_array_equal(
            tsyn.make_trajectory(kind, 40, 1.2, 0.7), jsyn.make_trajectory(kind, 40, 1.2, 0.7)
        )
    with pytest.raises(ValueError):
        tsyn.make_trajectory("spiral", 3)


def test_default_world_and_raycast_identical(rng):
    ours, ref = tsyn.default_world(5), jsyn.default_world(5)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in ("origin", "u", "v"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.roughness == b.roughness
    dirs = jsyn.lidar_directions(8, 120)
    origin = np.array([3.0, 0.5, 0.2])
    r_ours, i_ours = tsyn.raycast_hits(tsyn.RectSoA(ours), origin, dirs)
    r_ref, i_ref = jsyn.raycast_hits(jsyn.RectSoA(ref), origin, dirs)
    np.testing.assert_array_equal(r_ours, r_ref)
    np.testing.assert_array_equal(i_ours, i_ref)
    assert np.isfinite(r_ours).mean() > 0.5


def test_generate_sequence_poses_and_shapes():
    """Rigid sweeps: both generators cast through ``FrameRaycaster``, whose
    arithmetic the port's follows, so the scans are identical too."""
    cfg = dict(n_frames=4, num_beams=16, num_cols=180, num_points=512, seed=1)
    scans, poses = tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(**cfg), device="cpu")
    ref_scans, ref_poses = jsyn.generate_sequence(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(poses, ref_poses)
    assert scans.shape == ref_scans.shape == (4, 512, 3) and scans.dtype == np.float32
    np.testing.assert_array_equal(scans, ref_scans)


def test_motion_distorted_sequence_identical():
    """With motion distortion both generators cast with the same numpy
    raycaster, so the scans are identical."""
    cfg = dict(n_frames=3, num_beams=8, num_cols=96, num_points=256, seed=4,
               motion_distortion=True)
    s_ours, t_ours, p_ours = tsyn.generate_sequence_with_times(tsyn.SyntheticSequenceConfig(**cfg),
                                                               device="cpu")
    s_ref, t_ref, p_ref = jsyn.generate_sequence_with_times(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(s_ours, s_ref)
    np.testing.assert_array_equal(t_ours, t_ref)
    np.testing.assert_array_equal(p_ours, p_ref)


def test_kitti_world_sequence_runs_with_the_reference_poses():
    """``world="kitti"`` (formerly refused): the KITTI-profile world with its
    traffic, on a 3-frame cut at 16 x 180."""
    cfg = dict(n_frames=3, num_beams=16, num_cols=180, num_points=512, seed=5, world="kitti",
               trajectory="kitti_drive")
    scans, poses = tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(**cfg), device="cpu")
    ref_scans, ref_poses = jsyn.generate_sequence(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(poses, ref_poses)
    assert scans.shape == ref_scans.shape == (3, 512, 3)
    assert (np.linalg.norm(scans, axis=-1) > 0).all()


def test_world_along_path_identical():
    poses = jsyn.make_trajectory("curve", 60, 1.0, 1.5)
    ours, ref = tsyn.world_along_path(poses, seed=3), jsyn.world_along_path(poses, seed=3)
    assert len(ours) == len(ref) > 20
    for a, b in zip(ours, ref):
        for field in ("origin", "u", "v"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_along_path_sequence_identical_with_motion_distortion():
    cfg = dict(n_frames=3, num_beams=8, num_cols=96, num_points=256, seed=2, world="along_path",
               motion_distortion=True)
    s_ours, p_ours = tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(**cfg), device="cpu")
    s_ref, p_ref = jsyn.generate_sequence(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(s_ours, s_ref)
    np.testing.assert_array_equal(p_ours, p_ref)
    assert (np.linalg.norm(s_ours, axis=-1) > 0).mean() > 0.5


@pytest.fixture(scope="module")
def pair_sequences():
    """Two short along-path sequences from the port's generator."""
    return [
        tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(
            n_frames=5, trajectory="curve", world="along_path", num_beams=16, num_cols=128,
            num_points=1024, seed=seed), device="cpu")
        for seed in (1, 2)
    ]


def test_filter_scan_sensor_frame_identical(pair_sequences):
    scan = pair_sequences[0][0][1]
    for n in (128, 4096):  # fewer and more points than survive the filter
        ours = tsyn.filter_scan_sensor_frame(scan, n, np.random.default_rng(4))
        ref = jsyn.filter_scan_sensor_frame(scan, n, np.random.default_rng(4))
        np.testing.assert_array_equal(ours, ref)
        assert ours.shape == (n, 3) and ours.dtype == np.float32
        assert (ours[:, 2] >= -1.4).all() and (np.linalg.norm(ours, axis=-1) > 1e-3).all()


def test_random_augmentation_identical():
    from pwclonet_pylidarslam_torch.data import kitti as tkitti
    from pwclonet_pylidarslam_tpu.data import kitti as jkitti

    for seed in range(3):
        np.testing.assert_array_equal(tkitti.random_augmentation(np.random.default_rng(seed)),
                                      jkitti.random_augmentation(np.random.default_rng(seed)))


@pytest.mark.parametrize("augment", [False, True])
def test_synthetic_pair_dataset_matches_reference(pair_sequences, augment):
    kw = dict(num_points=128, augment=augment, seed=3)
    ours = tsyn.SyntheticPairDataset(pair_sequences, **kw)
    ref = jsyn.SyntheticPairDataset(pair_sequences, **kw)
    assert len(ours) == len(ref) == 8
    for i in (0, 5):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == {"xyz1", "xyz2", "gt_params"}
        np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
        np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
        np.testing.assert_allclose(a["gt_params"], b["gt_params"], atol=1e-6)
        assert a["gt_params"].dtype == np.float32 and a["xyz1"].dtype == np.float32
    for seed in (None, 7):  # the dataset's own stream, then a per-epoch seed
        got = list(ours.batches(4, shuffle=True, seed=seed))
        want = list(ref.batches(4, shuffle=True, seed=seed))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
            np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
            np.testing.assert_allclose(a["gt_params"], b["gt_params"], atol=1e-6)
            assert a["xyz1"].shape == (4, 128, 3) and a["gt_params"].shape == (4, 7)
    # gt maps xyz1 (current) into xyz2 (previous): unit quaternion, w >= 0
    q = got[0]["gt_params"][:, 3:]
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
    assert (q[:, 0] >= 0).all()


def _write_kitti(root, n_scans=3, n_points=600, seed=0):
    """A tiny KITTI odometry tree: sequence 04 with ``n_scans`` scans."""
    rng = np.random.default_rng(seed)
    vdir = root / "sequences" / "04" / "velodyne"
    vdir.mkdir(parents=True)
    for i in range(n_scans):
        pts = rng.normal(size=(n_points, 4)).astype(np.float32) * np.float32([12, 12, 1.0, 0.1])
        pts.tofile(vdir / f"{i:06d}.bin")
    tr = "Tr: 0 -1 0 0.01 0 0 -1 -0.07 1 0 0 -0.27"
    (root / "sequences" / "04" / "calib.txt").write_text(f"P0: 1 0 0 0 0 1 0 0 0 0 1 0\n{tr}\n")
    (root / "poses").mkdir()
    rows = []
    for i in range(n_scans):
        a = 0.02 * i
        pose = np.array([[np.cos(a), 0, np.sin(a), 0.1 * i], [0, 1, 0, 0.0],
                         [-np.sin(a), 0, np.cos(a), 1.0 * i]])
        rows.append(" ".join(f"{v:.9e}" for v in pose.reshape(-1)))
    (root / "poses" / "04.txt").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("augment", [False, True])
def test_kitti_pair_dataset_matches_reference(tmp_path, augment):
    from pwclonet_pylidarslam_torch.data import kitti as tkitti
    from pwclonet_pylidarslam_tpu.data import kitti as jkitti

    _write_kitti(tmp_path)
    kw = dict(num_points=256, augment=augment, seed=5)
    ours = tkitti.KittiPairDataset(str(tmp_path), [4], **kw)
    ref = jkitti.KittiPairDataset(str(tmp_path), [4], **kw)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a["xyz1"], b["xyz1"])
        np.testing.assert_array_equal(a["xyz2"], b["xyz2"])
        np.testing.assert_allclose(a["gt_params"], b["gt_params"], atol=1e-6)
    got, want = list(ours.batches(2, shuffle=True)), list(ref.batches(2, shuffle=True))
    assert len(got) == len(want) == 1 and got[0]["xyz1"].shape == (2, 256, 3)
    np.testing.assert_array_equal(got[0]["xyz1"], want[0]["xyz1"])
    np.testing.assert_allclose(got[0]["gt_params"], want[0]["gt_params"], atol=1e-6)

    seq, jseq = tkitti.KittiSequence(str(tmp_path), 4), jkitti.KittiSequence(str(tmp_path), 4)
    assert len(seq) == len(jseq) == 3
    np.testing.assert_array_equal(seq.scan(1), jseq.scan(1))
    np.testing.assert_array_equal(seq.ground_truth(), jseq.ground_truth())
