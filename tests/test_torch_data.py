"""The port's numpy copies: ``evaluation/metrics.py`` and the synthetic
sequence generator, against the JAX package's originals."""

import numpy as np
import pytest

from pwclonet_pylidarslam_torch.data import synthetic as tsyn
from pwclonet_pylidarslam_torch.evaluation import metrics as tmet
from pwclonet_pylidarslam_tpu.data import synthetic as jsyn
from pwclonet_pylidarslam_tpu.evaluation import metrics as jmet


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
    cfg = dict(n_frames=4, num_beams=16, num_cols=180, num_points=512, seed=1)
    scans, poses = tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(**cfg))
    ref_scans, ref_poses = jsyn.generate_sequence(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(poses, ref_poses)
    assert scans.shape == ref_scans.shape == (4, 512, 3) and scans.dtype == np.float32
    # rays are cast by another raycaster than the reference's: compare the
    # amount and spread of the points, not the points
    n_ours = (np.linalg.norm(scans, axis=-1) > 0).sum(1)
    n_ref = (np.linalg.norm(ref_scans, axis=-1) > 0).sum(1)
    np.testing.assert_array_equal(n_ours, n_ref)
    np.testing.assert_allclose(np.abs(scans).mean(), np.abs(ref_scans).mean(), rtol=0.05)


def test_motion_distorted_sequence_identical():
    """With motion distortion both generators cast with the same numpy
    raycaster, so the scans are identical."""
    cfg = dict(n_frames=3, num_beams=8, num_cols=96, num_points=256, seed=4,
               motion_distortion=True)
    s_ours, t_ours, p_ours = tsyn.generate_sequence_with_times(tsyn.SyntheticSequenceConfig(**cfg))
    s_ref, t_ref, p_ref = jsyn.generate_sequence_with_times(jsyn.SyntheticSequenceConfig(**cfg))
    np.testing.assert_array_equal(s_ours, s_ref)
    np.testing.assert_array_equal(t_ours, t_ref)
    np.testing.assert_array_equal(p_ours, p_ref)


def test_unported_world_raises():
    with pytest.raises(NotImplementedError, match="corridor"):
        tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(n_frames=2, world="kitti"))
