"""Voxel association of the port against the JAX reference on the CPU: the
voxel hash and grid sampling, per-voxel statistics, the bucket tables (both
builds), the nearest-neighbour queries, and the voxel odometry step. The
same float32 numpy inputs, made from a seed, go through both.

Tolerances: hashes, masks, tables and query results ``torch.equal`` to the
reference's (bit for bit); ``voxel_statistics`` means to 1e-5 and
covariances to 1e-4 (segment sums added in another order); one odometry
step from a state carried across to 1e-5 (pose), 2 matches and 1e-3
relative cost.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.core import pointcloud as tpc
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.slam import local_map as tlm
from pwclonet_pylidarslam_tpu.core import pointcloud as jpc
from pwclonet_pylidarslam_tpu.slam import icp_odometry as jicp
from pwclonet_pylidarslam_tpu.slam import local_map as jlm


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(got, ref):
    got, ref = N(got), N(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert np.array_equal(got, ref)


def cloud(rng, m=4000, reach=40.0):
    return rng.uniform(-reach, reach, (m, 3)).astype(np.float32)


# --- hashing and grid sampling ---------------------------------------------------


def test_voxel_hash_wraps_like_int32(rng):
    v = rng.integers(-3000, 3000, (5000, 3)).astype(np.int32)
    v[:4] = [[2**20, -2**20, 77], [-(2**24), 2**24 - 1, -(2**23)], [0, 0, 0], [1, 1, 1]]
    assert_equal(tpc.voxel_hash(T(v)), jpc.voxel_hash(jnp.asarray(v)))
    assert_equal(tpc.planar_hash(T(v)), jpc.planar_hash(jnp.asarray(v)))
    assert tpc.voxel_hash(T(v)).dtype == torch.int32


def test_voxelise_matches_reference(rng):
    pts = cloud(rng)
    pts[:10] = np.float32(0.75) * np.arange(10, dtype=np.float32)[:, None]  # .5 ties
    for args in ((0.5,), (0.45,), (0.3, 0.6, 1.2)):
        assert_equal(tpc.voxelise(T(pts), *args), jpc.voxelise(jnp.asarray(pts), *args))


@pytest.mark.parametrize("with_valid", [False, True])
def test_grid_sample_mask_and_fixed_match_reference(rng, with_valid):
    pts = cloud(rng, 6000, 10.0)
    pts[3000:] = pts[:3000] + 0.01  # many points share voxels
    valid = (rng.uniform(size=6000) > 0.3).astype(np.float32) if with_valid else None
    tv = None if valid is None else T(valid)
    jv = None if valid is None else jnp.asarray(valid)
    assert_equal(tpc.grid_sample_mask(T(pts), 0.45, tv), jpc.grid_sample_mask(jnp.asarray(pts), 0.45, jv))
    for a, b in zip(tpc.grid_sample_fixed(T(pts), 0.9, 700, tv),
                    jpc.grid_sample_fixed(jnp.asarray(pts), 0.9, 700, jv)):
        assert_equal(a, b)


def test_voxel_statistics_match_reference(rng):
    pts = cloud(rng, 3000, 5.0)
    valid = (rng.uniform(size=3000) > 0.2).astype(np.float32)
    ref = jpc.voxel_statistics(jnp.asarray(pts), 1.0, 1200, jnp.asarray(valid))
    got = tpc.voxel_statistics(T(pts), 1.0, 1200, T(valid))
    assert_equal(got.segment_ids, ref.segment_ids)
    assert_equal(got.counts, ref.counts)
    np.testing.assert_allclose(N(got.means), N(ref.means), atol=1e-5)
    np.testing.assert_allclose(N(got.covs), N(ref.covs), atol=1e-4)


# the default-lane scenarios of tests/test_preprocessing.py's pointcloud
# half, on the port


def test_grid_sample_mask_one_per_voxel(rng):
    pts = rng.uniform(0, 4, size=(500, 3))
    kept = pts[N(tpc.grid_sample_mask(T(pts), 1.0))]
    uniq = np.unique(np.round(kept).astype(int), axis=0)
    assert len(uniq) == len(kept) == len(np.unique(np.round(pts).astype(int), axis=0))


def test_grid_sample_fixed_shapes_and_voxel_statistics_means(rng):
    pts = rng.uniform(0, 3, size=(300, 3)).astype(np.float32)
    sampled, ok = tpc.grid_sample_fixed(T(pts), 1.0, 64)
    n_valid = int(N(ok).sum())
    assert sampled.shape == (64, 3) and 0 < n_valid <= 64
    assert np.all(N(sampled)[n_valid:] == 0)
    a = rng.normal(size=(200, 3)) * 0.05
    b = rng.normal(size=(100, 3)) * 0.05 + np.array([10, 0, 0])
    stats = tpc.voxel_statistics(T(np.concatenate([a, b]).astype(np.float32)), 1.0, max_voxels=16)
    counts = N(stats.counts)
    occupied = counts > 0
    assert occupied.sum() == 2
    assert sorted(round(float(m[0])) for m in N(stats.means)[occupied]) == [0, 10]
    np.testing.assert_allclose(sorted(counts[occupied]), [100, 200])


# --- bucket tables --------------------------------------------------------------


@pytest.mark.parametrize("table_size,cap,voxel", [(1 << 10, 4, 3.0), (1 << 14, 16, 0.8),
                                                  (1 << 8, 64, 3.0)])
def test_build_voxel_table_equals_reference(rng, table_size, cap, voxel):
    pts = cloud(rng, 5000, 30.0)
    nrm = rng.normal(size=(5000, 3)).astype(np.float32)
    ok = (rng.uniform(size=5000) > 0.1).astype(np.float32)
    ref = jlm.build_voxel_table(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(ok), voxel,
                                table_size, cap)
    got = tlm.build_voxel_table(T(pts), T(nrm), T(ok), voxel, table_size, cap)
    assert_equal(got.points, ref.points)
    assert_equal(got.normals, ref.normals)


@pytest.mark.parametrize("table_size,cap", [(1 << 10, 4), (1 << 14, 64), (1 << 6, 8)])
def test_build_voxel_table_fused_equals_reference(rng, table_size, cap):
    pts = cloud(rng, 6000, 20.0)
    pts[4000:] = pts[:2000] + 0.05  # duplicates inside subcells
    nrm = rng.normal(size=(6000, 3)).astype(np.float32)
    ok = (rng.uniform(size=6000) > 0.1).astype(np.float32)
    ref = jlm.build_voxel_table_fused(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(ok),
                                      3.0, 0.45, table_size, cap)
    got = tlm.build_voxel_table_fused(T(pts), T(nrm), T(ok), 3.0, 0.45, table_size, cap)
    assert_equal(got.points, ref.points)
    assert_equal(got.normals, ref.normals)


def test_scatter_buckets_equals_reference(rng):
    pts = cloud(rng, 3000)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    row = rng.integers(0, 200, 3000).astype(np.int32)
    ok = rng.uniform(size=3000) > 0.2
    ref = jlm.scatter_buckets(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(ok),
                              jnp.asarray(row), 200, 8)
    got = tlm.scatter_buckets(T(pts), T(nrm), T(ok), T(row), 200, 8)
    assert_equal(got.points, ref.points)
    assert_equal(got.normals, ref.normals)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(1)
    pts = cloud(rng, 8000, 25.0)
    nrm = rng.normal(size=(8000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[::11] = 0.0  # points without a normal
    ok = np.ones(8000, np.float32)
    out = {}
    for hood, cell in ((8, 3.0), (27, 1.5)):
        ref = jlm.build_voxel_table(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(ok), cell,
                                    1 << 12, 32)
        out[hood] = (ref, tlm.VoxelTable(T(ref.points), T(ref.normals)))
    query = (pts[:3000] + rng.normal(size=(3000, 3)) * 0.4).astype(np.float32)
    query[:20] = pts[:20]  # exact hits
    return out, query


@pytest.mark.parametrize("hood", [8, 27])
def test_neighbor_buckets_and_voxel_nn_equal_reference(tables, hood):
    out, query = tables
    ref_table, table = out[hood]
    assert_equal(tlm.neighbor_bucket_hashes(T(query), 1.5, 1 << 12, hood).to(torch.int32),
                 jlm.neighbor_bucket_hashes(jnp.asarray(query), 1.5, 1 << 12, hood))
    for reach in (1.5, 0.7):
        ref = jlm.voxel_nn(ref_table, jnp.asarray(query), 1.5, jnp.float32(reach), neighborhood=hood)
        got = tlm.voxel_nn(table, T(query), 1.5, reach, neighborhood=hood)
        for a, b in zip(got, ref):
            assert_equal(a, b)
    cj = jlm.gather_voxel_candidates(ref_table, jnp.asarray(query), 1.5, neighborhood=hood)
    ct = tlm.gather_voxel_candidates(table, T(query), 1.5, neighborhood=hood)
    for a, b in zip(ct, cj):
        assert_equal(a, b)
    moved = (query + 0.2).astype(np.float32)
    ref = jlm.nn_from_candidates(cj[0], cj[1], jnp.asarray(moved), jnp.float32(1.125))
    got = tlm.nn_from_candidates(ct[0], ct[1], T(moved), 1.125)
    for a, b in zip(got, ref):
        assert_equal(a, b)
    assert float(N(got[2]).sum()) > 500


def test_voxel_nn_is_exact_within_reach(rng):
    """tests/test_icp_odometry.py's octant-mode check, on the port."""
    pts = rng.uniform(-10, 10, (800, 3)).astype(np.float32)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    table = tlm.build_voxel_table(T(pts), T(nrm), torch.ones(800), 1.6, 1 << 14, 32)
    q = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    tgt, _, w = tlm.voxel_nn(table, T(q), 0.8, 0.75, neighborhood=8)
    d = np.linalg.norm(q[:, None] - pts[None], axis=-1)
    inside = d.min(1) < 0.74
    assert inside.sum() > 10 and np.all(N(w)[inside] > 0)
    np.testing.assert_allclose(N(tgt)[inside], pts[d.argmin(1)][inside], atol=1e-5)


def test_fused_voxel_build_matches_oracle():
    """tests/test_icp_odometry.py's numpy oracle of the fused build, on the port."""
    rng = np.random.default_rng(3)
    m, table_size, cap = 4000, 1 << 10, 4
    pts = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    ok = (rng.uniform(size=m) > 0.1).astype(np.float32)
    table = tlm.build_voxel_table_fused(T(pts), T(nrm), T(ok), 3.0, 0.45, table_size, cap)
    row = N(tpc.voxel_hash(T(np.floor(pts / 3.0).astype(np.int32)))).astype(np.int64) & (table_size - 1)
    sub_bits = 31 - int(table_size - 1).bit_length()
    sub = N(tpc.voxel_hash(T(np.floor(pts / 0.45).astype(np.int32)))).astype(np.uint32) & np.uint32(
        (1 << sub_bits) - 1)
    groups = {}
    for i in range(m):
        if ok[i] > 0:
            groups.setdefault((int(row[i]), int(sub[i])), i)
    buckets = {}
    for (r, _), i in sorted(groups.items()):
        if len(buckets.setdefault(r, [])) < cap:
            buckets[r].append(i)
    got = N(table.points)
    for r, idxs in buckets.items():
        real = got[r][np.linalg.norm(got[r], axis=-1) < 1e8]
        assert real.shape[0] == len(idxs)
        assert (np.linalg.norm(real[:, None] - pts[idxs][None], axis=-1).min(1) < 1e-5).all()
    for r in sorted(set(range(table_size)) - set(buckets))[:50]:
        assert (np.linalg.norm(got[r], axis=-1) > 1e8).all()


# --- the voxel odometry -------------------------------------------------------


@pytest.fixture(scope="module")
def scans4096():
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=12, trajectory="curve", speed=1.0, seed=2, num_points=4096))


VOXEL_CASES = {
    "voxel": dict(association="voxel"),
    "rebuild_every_3_fused": dict(association="voxel", voxel_rebuild_every=3,
                                  voxel_fused_build=True),
    "no_cache_reassociate_2": dict(association="voxel", voxel_candidate_cache=False,
                                   reassociate_every=2, voxel_neighborhood=27),
}


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_voxel_step_from_a_carried_state_matches_reference(tmp_path, scans4096, case):
    scans, _ = scans4096
    kw = dict(num_points=4096, **VOXEL_CASES[case])
    ref = jicp.ICPOdometry(jicp.ICPConfig(**kw))
    ref.init()
    ref.process_sequence(scans[:7])  # frame 7 rebuilds no table at R=3
    path = str(tmp_path / "state.npz")
    ref.snapshot(path)
    port = ticp.ICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    port.restore(path)
    for scan in scans[7:9]:
        ref.process_next_frame(scan)
        port.process_next_frame(scan)
        a, b = ref.results[-1], port.results[-1]
        np.testing.assert_allclose(b.pose, np.asarray(a.pose), atol=1e-5)
        assert abs(float(b.num_matches) - float(a.num_matches)) <= 2
        np.testing.assert_allclose(float(b.icp_cost), float(a.icp_cost), rtol=1e-3)
    if "rebuild" in case:  # the cached table carried across equals the reference's
        assert_equal(port.state.vox_pts, ref.state.vox_pts)


def test_voxel_skip_latest_keyframe_single_kf_guard():
    scans, _ = generate_sequence(SyntheticSequenceConfig(n_frames=3, num_points=4096, seed=5))
    cfg = ticp.ICPConfig(num_points=4096, association="voxel")
    assert cfg.voxel_skip_latest_keyframe
    odo = ticp.ICPOdometry(cfg, device="cpu")
    odo.init()
    for s in scans:
        odo.process_next_frame(s)
    assert float(odo.results[1].num_matches) > cfg.min_matches
    assert np.isfinite(odo.absolute_poses()).all()


def test_lazy_voxel_rebuild_tracks_the_trajectory(scans4096):
    """tests/test_icp_odometry.py's lazy-rebuild check, at 4096 points."""
    scans, gt = scans4096
    dist = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1).sum())
    for kw in (dict(voxel_rebuild_every=4), dict(voxel_rebuild_every=4, voxel_fused_build=True)):
        odo = ticp.ICPOdometry(ticp.ICPConfig(num_points=4096, map_stride=2, association="voxel",
                                              **kw), device="cpu")
        odo.init()
        odo.process_sequence(scans)
        pred = odo.absolute_poses()
        assert float(np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3])) / dist < 0.01
        # a table refresh is read once a frame, besides the iterations' reads
        assert all(r <= it + 2 for r, it in zip(odo.host_reads, odo.iterations))
