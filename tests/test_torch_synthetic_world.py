"""The port's KITTI-profile synthetic world (``data/synthetic.py``:
``DynamicBox``, ``kitti_world``, ``kitti_preset``, ``FrameRaycaster``,
``raycast`` and the rigid sweeps cast through ``FrameRaycaster``) against the
JAX package's, on the CPU.

The casters are held under the borderline-ray rule of
``tools/cast_check.py``: they may differ only at a ray that lies on a
boundary of the hit test, and every difference is checked to be one. The
host loop of the rigid sweeps (noise, dropout, sampling) is held bit-equal to
the reference's when both are fed the reference's casts: one flipped ray
changes what the sampler draws for the rest of a sequence, so whole
sequences are not the measure of the caster."""

import dataclasses

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.data import synthetic as tsyn
from pwclonet_pylidarslam_tpu.data import synthetic as jsyn
from tools.cast_check import cast_differences


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread: with several test workers on one
    machine, torch's thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_rects_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in ("origin", "u", "v"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.roughness == b.roughness


@pytest.mark.parametrize("seed", [3, 11])
def test_kitti_world_and_dynamic_boxes_identical(seed):
    poses = jsyn.make_trajectory("kitti_drive", 300)
    rects, dyn = tsyn.kitti_world(poses, seed)
    ref_rects, ref_dyn = jsyn.kitti_world(poses, seed)
    assert len(rects) > 100 and len(dyn) >= 1
    _assert_rects_equal(rects, ref_rects)
    assert len(dyn) == len(ref_dyn)
    for a, b in zip(dyn, ref_dyn):
        for field in ("center", "size", "velocity"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.roughness == b.roughness
        for t in (0, 7, 299):
            assert len(a.rects_at(t)) == 5  # four sides and a top, no bottom
            _assert_rects_equal(a.rects_at(t), b.rects_at(t))


def test_kitti_preset_identical():
    assert tsyn.GENERATOR_VERSION == jsyn.GENERATOR_VERSION
    for args, kw in (((), {}), ((48,), {"seed": 101}), ((5,), {"motion_distortion": True})):
        assert dataclasses.asdict(tsyn.kitti_preset(*args, **kw)) == dataclasses.asdict(
            jsyn.kitti_preset(*args, **kw))
    assert dataclasses.asdict(tsyn.SyntheticSequenceConfig()) == dataclasses.asdict(
        jsyn.SyntheticSequenceConfig())


def _kitti_frames(frames, beams, cols):
    """The 300-frame KITTI-profile world (seed 3, three moving boxes) at
    ``frames`` of its drive: the static rects, then each frame's instances
    of the boxes, as the generator lays them out."""
    trajectory = jsyn.make_trajectory("kitti_drive", 300)
    rects, dyn = jsyn.kitti_world(trajectory, 3)
    dyn_rects = [r for t in frames for d in dyn for r in d.rects_at(t)]
    per = len(dyn_rects) // len(frames)
    extra = [np.arange(len(rects) + i * per, len(rects) + (i + 1) * per)
             for i in range(len(frames))]
    dirs = jsyn.lidar_directions(beams, cols, 2.0, -24.8)
    return rects + dyn_rects, len(rects), trajectory[frames], dirs, extra


@pytest.mark.parametrize("world", ["kitti", "corridor"])
def test_frame_raycaster_matches_reference(world):
    """``cast_all`` on the CPU against the reference's jitted caster: the
    KITTI-profile world at 16 x 180 over 4 frames with its traffic, and the
    corridor along a curve (rotated rays, no extras)."""
    if world == "kitti":
        rects, n_static, poses, dirs, extra = _kitti_frames([40, 120, 200, 280], 16, 180)
    else:
        rects, poses = jsyn.default_world(1), jsyn.make_trajectory("curve", 4, 1.0, 6.0)
        n_static, dirs, extra = len(rects), jsyn.lidar_directions(16, 180), None
    ours = tsyn.FrameRaycaster(rects, n_static=n_static, device="cpu")
    ranges, idx = ours.cast_all(poses, dirs, extra)
    ref_ranges, ref_idx = jsyn.FrameRaycaster(rects, n_static=n_static).cast_all(
        poses, dirs, extra)
    assert ranges.shape == idx.shape == (4, len(dirs))
    assert ranges.dtype == np.float32 and idx.dtype == np.int32
    assert np.isfinite(ranges).mean() > 0.8
    if world == "kitti":
        assert (idx >= n_static).sum() > 20  # the traffic is hit
    diff = cast_differences(ours.soa, poses, dirs, ranges, idx, ref_ranges, ref_idx)
    assert diff["unexplained"] == 0, diff
    assert diff["differing"] <= 1e-3 * diff["rays"], diff


def test_cast_differences_finds_only_borderline_rays():
    """The rule itself: on one 2 x 2 m wall 10 m ahead, a ray at its edge
    may flip and a ray at its centre may not."""
    wall = [tsyn.Rect(np.array([10.0, -1.0, -1.0]), np.array([0, 2.0, 0]),
                      np.array([0, 0, 2.0]))]
    soa = tsyn.RectSoA(wall)
    dirs = np.array([[10.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.05, 0.05]])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    poses = np.eye(4)[None]
    ranges, idx = tsyn.FrameRaycaster(wall, device="cpu").cast_all(poses, dirs)
    assert (idx == 0).all()
    assert cast_differences(soa, poses, dirs, ranges, idx, ranges, idx)["differing"] == 0
    for ray, unexplained in ((0, 0), (1, 1), (2, 1)):
        r2, i2 = ranges.copy(), idx.copy()
        r2[0, ray], i2[0, ray] = np.inf, -1
        diff = cast_differences(soa, poses, dirs, ranges, idx, r2, i2)
        assert diff["hit_vs_miss"] == 1 and diff["unexplained"] == unexplained, (ray, diff)
    r2 = ranges.copy()
    r2[0, 1] = np.nextafter(r2[0, 1], np.float32(np.inf))
    assert cast_differences(soa, poses, dirs, ranges, idx, r2, idx)["same_rect_range"] == 1


def test_rigid_host_loop_identical_on_the_reference_casts(monkeypatch):
    """The rigid sweeps of a KITTI-profile world with a moving box, the
    port's caster replaced by the reference's: noise from the hit rect's
    roughness, dropout and the sample draw the reference's numbers in its
    order, so scans, times and poses are bit-equal."""
    cfg = dict(num_beams=16, num_cols=180, num_points=1024)
    extras = []

    def reference_caster(rects, n_static=None, device=None):
        caster = jsyn.FrameRaycaster(rects, n_static=n_static)
        cast_all = caster.cast_all

        def recorded(poses, dirs, extra_sets=None):
            extras.append(extra_sets)
            return cast_all(poses, dirs, extra_sets)

        caster.cast_all = recorded
        return caster

    monkeypatch.setattr(tsyn, "FrameRaycaster", reference_caster)
    ours = tsyn.generate_sequence_with_times(
        dataclasses.replace(tsyn.kitti_preset(24, seed=5), **cfg), device="cpu")
    ref = jsyn.generate_sequence_with_times(dataclasses.replace(jsyn.kitti_preset(24, seed=5),
                                                                **cfg))
    assert len(extras) == 1 and len(extras[0]) == 24  # traffic: one set of rects a frame
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert (np.linalg.norm(ours[0], axis=-1) > 0).sum(1).min() > 900


def test_kitti_sequence_poses_and_scans():
    """``world="kitti"`` with its traffic, end to end on the port's caster:
    the reference's poses; dense scans at the preset's 64 x 720 over a 4-frame
    cut of its drive."""
    cfg = tsyn.kitti_preset(4, seed=5)
    scans, times, poses = tsyn.generate_sequence_with_times(cfg, device="cpu")
    np.testing.assert_array_equal(poses, jsyn.make_trajectory("kitti_drive", 4).astype(np.float64))
    assert scans.shape == (4, 8192, 3) and scans.dtype == np.float32
    assert (np.linalg.norm(scans, axis=-1) > 1e-3).sum(1).min() > 6000
    assert times.max() < 1.0 and times.min() >= 0.0


def test_dynamic_object_points_move_between_frames():
    """``tests/test_synthetic.py``'s moving box on the port's caster: the
    centroid of its hits tracks the box's +0.5 m/frame in y."""
    ground = [tsyn.Rect(np.array([-100.0, -100.0, -1.7]), np.array([200.0, 0, 0]),
                        np.array([0, 200.0, 0]))]
    box = tsyn.DynamicBox(center=np.array([10.0, 0.0, -0.9]), size=np.array([3.0, 2.0, 1.6]),
                          velocity=np.array([0.0, 0.5, 0.0]))
    n = 5
    dirs = tsyn.lidar_directions(16, 360)
    dyn_rects = [r for t in range(n) for r in box.rects_at(t)]
    caster = tsyn.FrameRaycaster(ground + dyn_rects, n_static=1, device="cpu")
    extra = [np.arange(1 + t * 5, 1 + (t + 1) * 5) for t in range(n)]
    ranges, idx = caster.cast_all(tsyn.make_trajectory("straight", n, speed=0.0), dirs, extra)
    ys = []
    for t in range(n):
        hit = np.isfinite(ranges[t]) & (idx[t] >= 1)
        assert hit.sum() > 10
        ys.append((dirs[hit] * ranges[t][hit, None])[:, 1].mean())
    dy = np.diff(ys)
    assert (dy > 0.3).all() and (dy < 0.7).all(), dy


def test_raycast_wrapper():
    rects = jsyn.default_world(2)
    dirs = jsyn.lidar_directions(8, 90)
    origins = np.tile([2.0, 0.5, 0.0], (len(dirs), 1))
    np.testing.assert_array_equal(tsyn.raycast(rects, origins, dirs),
                                  jsyn.raycast(rects, origins, dirs))
    origins[3, 0] += 1.0
    with pytest.raises(ValueError, match="origins equal"):
        tsyn.raycast(rects, origins, dirs)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine "
                    "without a CUDA card")
def test_caster_and_generator_refuse_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.FrameRaycaster(jsyn.default_world(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.generate_sequence(tsyn.SyntheticSequenceConfig(n_frames=2, num_beams=4,
                                                            num_cols=16))
