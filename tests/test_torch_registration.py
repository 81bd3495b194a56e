"""BEV registration, the initialization priors, preprocessing and ICP state
snapshots of the port against the JAX reference on the CPU, and the
reference's accuracy scenarios (fast rotation, the KITTI-profile world) run
through both.

Tolerances: Procrustes poses to 1e-5; elevation images bit-equal; phase
correlation shifts equal and confidences to 1e-4 relative; polar spectra
to 1e-4 relative (FFT libraries differ); de-skewed points to 1e-5 at 20 m;
snapshot leaves bit-identical after a round trip through both
implementations; drift of the fast-rotation sequence within 0.01 of the
reference's own (the trajectory moves by more when its scans move by an
ulp).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.core import registration as treg, se3 as tse3
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.slam import initialization as tinit
from pwclonet_pylidarslam_torch.slam import preprocessing as tpre
from pwclonet_pylidarslam_tpu.core import registration as jreg, se3 as jse3
from pwclonet_pylidarslam_tpu.slam import icp_odometry as jicp
from pwclonet_pylidarslam_tpu.slam import initialization as jinit
from pwclonet_pylidarslam_tpu.slam import preprocessing as jpre


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scan_pair():
    scans, gt = generate_sequence(SyntheticSequenceConfig(
        n_frames=2, trajectory="curve", speed=1.5, yaw_rate_deg=6.0, seed=4, num_points=4096))
    return scans, gt


# --- registration ---------------------------------------------------------------


def test_weighted_procrustes_matches_reference(rng):
    src = (rng.normal(size=(3, 300, 3)) * 30).astype(np.float32)
    pose = np.asarray(jse3.exp(jnp.asarray((rng.normal(size=(3, 6)) * 0.3).astype(np.float32))))
    tgt = np.asarray(jse3.transform(jnp.asarray(pose), jnp.asarray(src)))
    tgt = (tgt + rng.normal(size=tgt.shape) * 0.05).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, 300)).astype(np.float32)
    ref = np.asarray(jreg.weighted_procrustes(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
    got = N(treg.weighted_procrustes(T(src), T(tgt), T(w)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, pose, atol=5e-3)


def test_elevation_image_and_phase_correlation_match_reference(scan_pair):
    scans, _ = scan_pair
    cfg_j, cfg_t = jreg.BEVConfig(pixel_size=0.4), treg.BEVConfig(pixel_size=0.4)
    mask = (np.linalg.norm(scans, axis=-1) > 1e-3).astype(np.float32)
    ij = [np.asarray(jreg.build_elevation_image(jnp.asarray(s), cfg_j, jnp.asarray(m)))
          for s, m in zip(scans, mask)]
    it = [N(treg.build_elevation_image(T(s), cfg_t, T(m))) for s, m in zip(scans, mask)]
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(b, a)
    win = np.asarray(jreg._hann2d(256, jnp.float32))
    np.testing.assert_allclose(N(treg._hann2d(256, torch.float32, "cpu")), win, atol=1e-7)
    a, b = (x * win for x in ij)
    sj, cj = jreg._phase_correlate(jnp.asarray(a), jnp.asarray(b))
    st, ct = treg._phase_correlate(T(a), T(b))
    np.testing.assert_array_equal(N(st), np.asarray(sj))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    pj = np.asarray(jreg._log_polar_spectrum(jnp.asarray(a)))
    pt = N(treg._log_polar_spectrum(T(a)))
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-5)
    yj, _ = jreg.estimate_yaw(jnp.asarray(a), jnp.asarray(b))
    yt, _ = treg.estimate_yaw(T(a), T(b))
    assert float(yt) == pytest.approx(float(yj), abs=1e-6)


def test_register_bev_and_planar_pose_match_reference(scan_pair):
    scans, gt = scan_pair
    mask = (np.linalg.norm(scans, axis=-1) > 1e-3).astype(np.float32)
    cfg_j, cfg_t = jreg.BEVConfig(pixel_size=0.4), treg.BEVConfig(pixel_size=0.4)
    rj = jreg.register_bev(*map(jnp.asarray, (scans[0], mask[0], scans[1], mask[1])), cfg_j)
    rt = treg.register_bev(*map(T, (scans[0], mask[0], scans[1], mask[1])), cfg_t)
    assert float(rt.yaw) == pytest.approx(float(rj.yaw), abs=1e-6)
    np.testing.assert_array_equal(N(rt.translation), np.asarray(rj.translation))
    assert float(rt.confidence) == pytest.approx(float(rj.confidence), rel=1e-4)
    np.testing.assert_allclose(N(treg.planar_to_pose(rt)), np.asarray(jreg.planar_to_pose(rj)),
                               atol=1e-6)
    rel_gt = np.linalg.inv(gt[0]) @ gt[1]
    assert abs(float(rt.yaw) - np.arctan2(rel_gt[1, 0], rel_gt[0, 0])) < np.deg2rad(2.0)
    pts = scans[0][:50]
    np.testing.assert_allclose(N(treg.rotate_points_z(T(pts), torch.tensor(0.3))),
                               np.asarray(jreg.rotate_points_z(jnp.asarray(pts), jnp.float32(0.3))),
                               atol=1e-5)


# --- initialization ---------------------------------------------------------------


def test_initializations_match_reference(scan_pair):
    scans, _ = scan_pair
    ej = jinit.ElevationImageInitialization()
    et = tinit.ElevationImageInitialization(device="cpu")
    for o in (ej, et):
        o.init()
    for s in scans:
        np.testing.assert_allclose(et.next_frame(s, np.eye(4)), ej.next_frame(s, np.eye(4)),
                                   atol=1e-6)
    cv = tinit.ConstantVelocityInitialization()
    cv.init()
    rel = np.eye(4)
    rel[0, 3] = 1.2
    np.testing.assert_array_equal(cv.next_frame(None, None), np.eye(4))
    cv.feed_result(rel)
    np.testing.assert_array_equal(cv.next_frame(None, None), rel)
    np.testing.assert_array_equal(tinit.NoInitialization().next_frame(None, None), np.eye(4))
    assert set(tinit.INITIALIZATION) == set(jinit.INITIALIZATION)


def test_posenet_initialization_wraps_any_front_end():
    class FrontEnd:  # the interface of the reference's deep odometry drivers
        def init(self):
            self.t = 0.0

        def process_next_frame(self, points):
            self.t += 1.0
            pose = np.eye(4)
            pose[0, 3] = self.t
            return pose

    for cls in (tinit.PoseNetInitialization, jinit.PoseNetInitialization):
        init = cls(FrontEnd())
        init.init()
        rels = [init.next_frame(None, None) for _ in range(3)]
        np.testing.assert_allclose(rels[1][0, 3], 1.0)


def test_initialization_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit.ElevationImageInitialization()


# --- preprocessing ---------------------------------------------------------------


def test_deskew_matches_reference_and_corrects_motion():
    n = 720
    az = np.linspace(np.pi - 1e-3, -np.pi + 1e-3, n)
    static = np.stack([20 * np.cos(az), 20 * np.sin(az), np.zeros(n)], -1)
    frac = (np.pi - az) / (2 * np.pi)
    motion = np.asarray([2.0, 0.0, 0.0, 0.0, 0.0, 0.05])
    rel = N(tse3.exp(T(motion)))
    measured = np.stack([
        (np.linalg.inv(N(tse3.exp(T(f * motion)))) @ np.append(p, 1.0))[:3]
        for f, p in zip(frac, static)])
    fixed = N(tpre.deskew(T(measured), T(rel), timestamps=T(frac)))
    assert np.linalg.norm(measured - static, axis=1).max() > 1.0
    assert np.linalg.norm(fixed - static, axis=1).max() < 0.05
    pts = measured.astype(np.float32)
    ref = np.asarray(jpre.deskew(jnp.asarray(pts), jnp.asarray(rel.astype(np.float32))))
    got = N(tpre.deskew(T(pts), T(rel.astype(np.float32))))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_preprocessing_matches_reference(rng):
    pts = rng.uniform(-5, 5, size=(400, 3)).astype(np.float32)
    mask = np.ones(400, np.float32)
    mask[::9] = 0.0
    rel = np.asarray(jse3.exp(jnp.asarray([0.5, 0.1, 0.0, 0.0, 0.0, 0.02], jnp.float32)))
    for cfg in (dict(deskew=True, grid_sample_voxel=1.0), dict(grid_sample_voxel=0.5), {}):
        pj, mj = jpre.Preprocessing(jpre.PreprocessingConfig(**cfg))(
            jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rel))
        pt, mt = tpre.Preprocessing(tpre.PreprocessingConfig(**cfg))(T(pts), T(mask), T(rel))
        np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-5)
        np.testing.assert_array_equal(N(mt), np.asarray(mj))
    np.testing.assert_allclose(N(tpre.deskew(T(pts), torch.eye(4))), pts, atol=1e-6)
    stats_j = jpre.voxelization_stats(jnp.asarray(pts), jnp.asarray(mask), 1.0, 256)
    stats_t = tpre.voxelization_stats(T(pts), T(mask), 1.0, 256)
    np.testing.assert_array_equal(N(stats_t.counts), np.asarray(stats_j.counts))


# --- state carried across ---------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(association="voxel", voxel_rebuild_every=2)],
                         ids=["projective", "voxel_lazy"])
def test_snapshot_round_trip_is_bit_identical(tmp_path, kw):
    scans, _ = generate_sequence(SyntheticSequenceConfig(n_frames=3, num_points=2048, seed=1))
    cfg = dict(num_points=2048, **kw)
    ref = jicp.ICPOdometry(jicp.ICPConfig(**cfg))
    ref.init()
    ref.process_sequence(scans)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    ref.snapshot(a)
    port = ticp.ICPOdometry(ticp.ICPConfig(**cfg), device="cpu")
    port.restore(a)
    assert len(ticp.state_leaves(port.state)) == 16 and len(port.results) == 3
    port.snapshot(b)
    back = jicp.ICPOdometry(jicp.ICPConfig(**cfg))
    back.restore(b)
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), k
    import jax
    for x, y in zip(jax.tree.leaves(ref.state), jax.tree.leaves(back.state)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x), np.asarray(y))


# --- the reference's accuracy scenarios -------------------------------------------


def _drift(pred, gt):
    d = np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3])
    return d / max(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1).sum(), 1e-9)


@pytest.fixture(scope="module")
def fast_turn():
    """TestBEVBootstrap's sequence (tests/test_icp_odometry.py), at 4096 points."""
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=10, trajectory="curve", speed=0.8, yaw_rate_deg=12.0, seed=4, num_points=4096))


def _nudged(scans, direction):
    """The scans moved by one float32 ulp (padding rows stay zero)."""
    return np.where(scans != 0, np.nextafter(scans, np.float32(direction)), 0.0).astype(np.float32)


@pytest.mark.parametrize("boot", [False, True], ids=["plain_cv", "bev_bootstrap"])
def test_fast_rotation_drift_is_the_references(fast_turn, boot):
    """Held to the drift the reference gives on the same scans, not to the
    premise of ``test_plain_cv_fails_fast_rotation`` (ROADMAP.md Queue C):
    within 0.01 of the range the reference's drift spans over the scans and
    the scans moved by one ulp up and down (0.078 to 0.103 without the
    bootstrap at 4096 points)."""
    scans, gt = fast_turn
    kw = dict(num_points=4096, bev_bootstrap=boot)
    ref = []
    for s in (scans, _nudged(scans, np.inf), _nudged(scans, -np.inf)):
        odo = jicp.ICPOdometry(jicp.ICPConfig(**kw))
        odo.init()
        odo.process_sequence(s)
        ref.append(_drift(odo.absolute_poses(), gt))
    port = ticp.ICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    port.init()
    port.process_sequence(scans)
    d_port = _drift(port.absolute_poses(), gt)
    assert min(ref) - 0.01 <= d_port <= max(ref) + 0.01, (d_port, ref)
    if boot:
        assert d_port < 0.01  # the bootstrap rescues the fast turn in both


@pytest.mark.slow
@pytest.mark.parametrize("association,gate", [("projective", 0.32), ("voxel", 0.20)])
def test_kitti_profile_fast_tier_t_rel(association, gate):
    """The fast tier of tests/test_kitti_profile_accuracy.py: the 120-frame
    32-beam kitti_drive world (made by the reference's generator, which the
    port does not have yet) through the port, under the reference's gates."""
    from pwclonet_pylidarslam_tpu.data.synthetic import (
        SyntheticSequenceConfig as JConfig,
        generate_sequence as jgenerate,
    )
    from pwclonet_pylidarslam_torch.evaluation import metrics

    scans, gt = jgenerate(JConfig(
        n_frames=120, trajectory="kitti_drive", world="kitti", speed=1.0, num_beams=32,
        num_cols=720, fov_up_deg=2.0, fov_down_deg=-24.8, noise_std=0.02, dropout=0.08,
        num_points=4096, seed=3))
    kw = dict(num_points=4096, map_stride=2, bev_bootstrap=True, association=association)
    if association == "projective":
        kw.update(model_rebuild_trans=4.0, model_rebuild_rot=5.0)
    odo = ticp.ICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    odo.init()
    odo.process_sequence(np.asarray(scans))
    t_rel, _, _ = metrics.compute_kitti_metrics(odo.absolute_poses(), np.asarray(gt))
    assert t_rel is not None and 100.0 * t_rel < gate, 100.0 * t_rel
