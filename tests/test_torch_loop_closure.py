"""Loop closure of the port against the reference on the CPU: the ICP
refinement from one state (one iteration to 1e-6; all eight to 1e-5, or to
3x the reference's own spread when its source cloud moves by one float32
ulp, if larger: a match that flips at the gate or between near-equal
neighbours moves the later iterations), the straight line that must find no
loop, the revisit scenario of ``tests/test_loop_closure.py`` (the same
``(frame_i, frame_j)`` pairs, relative poses within 1e-4, confidences within
1e-4 relative), and ``serialize`` files of either implementation loading
into the other. The same float32 numpy clouds go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.core.registration import BEVConfig as TBEV
from pwclonet_pylidarslam_torch.slam import loop_closure as tlc
from pwclonet_pylidarslam_tpu.core import se3 as jse3
from pwclonet_pylidarslam_tpu.core.registration import BEVConfig as JBEV
from pwclonet_pylidarslam_tpu.slam import loop_closure as jlc
from test_loop_closure import structured_cloud

REVISIT = dict(submap_size=5, overlap=2, min_id_distance=8, points_per_frame=1024,
               submap_points=4096, min_confidence=1.2, max_icp_rmse=1.0)
STRAIGHT = dict(submap_size=4, overlap=1, min_id_distance=6, max_distance=20.0,
                points_per_frame=512, submap_points=2048)


def _configs(kw, image_size):
    return (jlc.LoopClosureConfig(**kw, bev=JBEV(pixel_size=0.5, image_size=image_size)),
            tlc.LoopClosureConfig(**kw, bev=TBEV(pixel_size=0.5, image_size=image_size)))


def test_refine_icp_from_one_state_matches_reference(rng):
    cfg_j, cfg_t = _configs(REVISIT, 192)
    world = structured_cloud(rng, 6000)
    tgt = world[:4096].copy()
    tgt_mask = (rng.uniform(size=4096) > 0.3).astype(np.float32)
    truth = np.asarray(jse3.exp(jnp.asarray([0.8, -0.4, 0.05, 0.0, 0.01, 0.04])))
    src = ((world[1000:5096] - truth[:3, 3]) @ truth[:3, :3]).astype(np.float32)
    src += rng.normal(scale=0.02, size=src.shape).astype(np.float32)
    src_mask = np.ones(4096, np.float32)
    src_mask[::7] = 0.0
    init = np.asarray(jse3.exp(jnp.asarray([0.5, -0.2, 0.0, 0.0, 0.0, 0.02])), np.float32)
    refine = jax.jit(lambda *a: jlc._refine_icp(cfg_j, *a))
    ref = refine(*(jnp.asarray(x) for x in (src, src_mask, tgt, tgt_mask, init)))
    # the reference's own spread when the source cloud moves by one float32
    # ulp: a match that flips at the 2 m gate or between two near-equal
    # neighbours moves the pose of the next iterations
    sens = 0.0
    for direction in (np.inf, -np.inf):
        nudged = np.nextafter(src, np.float32(direction)).astype(np.float32)
        moved = refine(*(jnp.asarray(x) for x in (nudged, src_mask, tgt, tgt_mask, init)))
        sens = max(sens, float(np.abs(np.asarray(moved[0]) - np.asarray(ref[0])).max()))
    got = tlc._refine_icp(cfg_t, *(torch.from_numpy(x) for x in (src, src_mask, tgt, tgt_mask,
                                                                    init)))
    gap = float(np.abs(got[0].numpy() - np.asarray(ref[0])).max())
    assert gap <= max(1e-5, 3.0 * sens), (gap, sens)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
    # one iteration, before any match can flip, agrees to 1e-6
    one_j, one_t = _configs(dict(REVISIT, icp_iterations=1), 192)
    ref1 = jax.jit(lambda *a: jlc._refine_icp(one_j, *a))(
        *(jnp.asarray(x) for x in (src, src_mask, tgt, tgt_mask, init)))
    got1 = tlc._refine_icp(one_t, *(torch.from_numpy(x) for x in (src, src_mask, tgt, tgt_mask,
                                                                     init)))
    np.testing.assert_allclose(got1[0].numpy(), np.asarray(ref1[0]), atol=1e-6, rtol=0)
    # and it moves towards the truth
    assert np.abs(got[0].numpy() - truth).max() < 0.25 * np.abs(init - truth).max()


def test_no_false_positive_on_straight_line(rng):
    cfg_j, cfg_t = _configs(STRAIGHT, 128)
    world = structured_cloud(rng, 4000)
    lcs = (jlc.ElevationImageLoopClosure(cfg_j), tlc.ElevationImageLoopClosure(cfg_t, device="cpu"))
    for t in range(12):
        pose = np.eye(4)
        pose[:3, 3] = [t * 30.0, 0, 0]  # always far from previous submaps
        inv = np.linalg.inv(pose)
        pts = ((inv[:3, :3] @ world.T).T + inv[:3, 3]).astype(np.float32)
        for lc in lcs:
            lc.process_next_frame(pts[:2000], pose)
    assert lcs[0].constraints == [] and lcs[1].constraints == []
    assert len(lcs[1].submaps) == len(lcs[0].submaps) == 3
    for a, b in zip(*(lc.submaps for lc in lcs)):
        np.testing.assert_allclose(b.points, np.asarray(a.points), atol=1e-4)
        np.testing.assert_array_equal(b.mask, np.asarray(a.mask))


@pytest.fixture(scope="module")
def revisit():
    """The revisit scenario of tests/test_loop_closure.py run through both."""
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = _configs(REVISIT, 192)
    world = structured_cloud(rng, 8000)

    def observe(pose):
        inv = np.linalg.inv(pose)
        pts = (inv[:3, :3] @ world.T).T + inv[:3, 3]
        keep = np.linalg.norm(pts[:, :2], axis=1) < 45
        out = np.zeros((6000, 3), np.float32)
        sel = pts[keep][:6000]
        out[: len(sel)] = sel
        return out

    lcs = (jlc.ElevationImageLoopClosure(cfg_j), tlc.ElevationImageLoopClosure(cfg_t, device="cpu"))
    found = ([], [])
    for t in range(16):
        pose = np.eye(4)
        pose[:3, 3] = [t * 2.0, 0, 0] if t < 8 else [(15 - t) * 2.0, 0.5, 0]
        scan = observe(pose)
        for lc, out in zip(lcs, found):
            out += lc.process_next_frame(scan, pose)
    return lcs, found


def test_revisit_finds_the_references_constraints(revisit):
    (ref_lc, lc), (ref, got) = revisit
    assert len(ref) >= 1
    assert [(c.frame_i, c.frame_j) for c in got] == [(c.frame_i, c.frame_j) for c in ref]
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.relative_pose, a.relative_pose, atol=1e-4)
        np.testing.assert_allclose(b.confidence, a.confidence, rtol=1e-4)
        gt_rel = np.linalg.inv(lc.frame_poses[b.frame_i]) @ lc.frame_poses[b.frame_j]
        assert np.linalg.norm(b.relative_pose[:3, 3] - gt_rel[:3, 3]) < 1.0
    st = lc.stats
    assert st.frames == 16 and st.submaps == len(lc.submaps) >= 2
    assert st.accepted == len(got) <= st.refinements <= st.candidates
    # one read a frame and a submap (the sampled clouds), one a candidate
    # (confidence) and one a refinement (pose and RMSE)
    assert st.host_reads == st.frames + st.submaps + st.candidates + st.refinements


def test_serialize_loads_across_implementations(tmp_path, revisit):
    (ref_lc, lc), _ = revisit
    for src, dst in ((ref_lc, tlc.ElevationImageLoopClosure(device="cpu")),
                     (lc, jlc.ElevationImageLoopClosure())):
        path = str(tmp_path / f"{type(src).__module__.split('.')[0]}.npz")
        src.serialize(path)
        dst.load(path)
        np.testing.assert_array_equal(np.stack(dst.frame_poses), np.stack(src.frame_poses))
        assert len(dst.submaps) == len(src.submaps)
        for a, b in zip(src.submaps, dst.submaps):
            np.testing.assert_array_equal(b.points, np.asarray(a.points))
            np.testing.assert_array_equal(b.mask, np.asarray(a.mask))
            assert b.mid_frame_id == a.mid_frame_id
            np.testing.assert_array_equal(b.mid_pose, a.mid_pose)
        assert [(c.frame_i, c.frame_j, c.confidence) for c in dst.constraints] == [
            (c.frame_i, c.frame_j, c.confidence) for c in src.constraints]
        for a, b in zip(src.constraints, dst.constraints):
            np.testing.assert_array_equal(b.relative_pose, a.relative_pose)


def test_update_positions_moves_submap_centres(revisit):
    (_, lc), _ = revisit
    traj = np.stack(lc.frame_poses).copy()
    traj[:, 0, 3] += 3.0
    lc.update_positions(traj)
    for sm in lc.submaps:
        np.testing.assert_array_equal(sm.mid_pose, traj[sm.mid_frame_id])


def test_config_defaults_match_reference():
    a, b = jlc.LoopClosureConfig(), tlc.LoopClosureConfig()
    for f in ("submap_size", "overlap", "max_num_candidates", "max_distance", "min_id_distance",
              "sample_voxel_size", "points_per_frame", "submap_points", "min_confidence",
              "icp_iterations", "icp_max_distance", "max_icp_rmse", "max_discrepancy_trans",
              "max_discrepancy_rot"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.bev.pixel_size, a.bev.image_size) == (b.bev.pixel_size, b.bev.image_size)
