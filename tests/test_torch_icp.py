"""Projective ICP odometry of the port against the JAX reference on the CPU:
projection and z-buffer, normal maps, the robust Gauss-Newton solvers, the
keyframe map and its model map, and the odometry step and driver. The same
float32 numpy inputs, made from a seed, go through both.

Tolerances, and why:
- pixel coordinates to 1e-4 px (libm differences of atan2/asin);
- z-buffer maps exactly equal, on constructed scenes and on scans;
- normals: the reference's ``M⁻¹S`` on float32 window moments cancels
  heavily (a 1e-6 change of M moves a normal by 1e-2), so they are held
  against each other by quantiles (median 1e-4, 99th percentile 0.05) and
  each against the float64 solution of the same vertex map, where the
  port must be no further off than the reference;
- Gauss-Newton poses at 80 m scale to 1e-5;
- one odometry step from a state carried across to 1e-5 (pose),
  2 matches and 1e-3 relative cost;
- a 12-frame sequence: the reference's own trajectory moves up to 1.4 cm
  when its input scans move by one float32 ulp (ROADMAP.md Queue C), so the
  port's chain is held to 3x that sensitivity, and both to the accuracy
  bounds of ``tests/test_icp_odometry.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.core import geometry as tg, optimization as topt
from pwclonet_pylidarslam_torch.core import projection as tp, se3 as tse3
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.evaluation import metrics
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.slam import local_map as tlm
from pwclonet_pylidarslam_tpu.core import geometry as jg, optimization as jopt
from pwclonet_pylidarslam_tpu.core import projection as jp, se3 as jse3
from pwclonet_pylidarslam_tpu.slam import icp_odometry as jicp
from pwclonet_pylidarslam_tpu.slam import local_map as jlm


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ring_cloud(rng, n=5000, rmin=3.0, rmax=80.0):
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.deg2rad(-23.5), np.deg2rad(2.5), n)
    r = rng.uniform(rmin, rmax, n)
    return np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1
    ).astype(np.float32)


@pytest.fixture(scope="module")
def scans4096():
    """The ``sequence`` fixture of tests/test_icp_odometry.py at 4096 points."""
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=12, trajectory="curve", speed=1.0, seed=2, num_points=4096))


# --- projection --------------------------------------------------------------


def test_pixel_coords_match_reference(rng):
    pts = ring_cloud(rng)[None]
    pts[0, :10] = 0.0  # invalid points
    ref = jp.spherical_pixel_coords(jnp.asarray(pts), 64, 720, 3.0, -24.0)
    got = tp.spherical_pixel_coords(T(pts), 64, 720, 3.0, -24.0)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(N(b), N(a), atol=1e-4, rtol=0)
    assert np.all(N(got[0])[0, :10] == -1.0) and np.all(N(got[2])[0, :10] == 0.0)


@pytest.mark.parametrize("scene", ["ring", "duplicates", "same_pixel_depths", "off_image"])
def test_zbuffer_equals_reference(rng, scene):
    pts = ring_cloud(rng, 6000)
    if scene == "duplicates":  # exact depth ties: the lowest index must win
        pts = np.concatenate([pts[:2000], pts[:2000], pts[1000:3000]])
    elif scene == "same_pixel_depths":  # many points on few pixels
        pts = (pts[:, None] * np.linspace(0.5, 1.5, 7, dtype=np.float32)[None, :, None])
        pts = pts.reshape(-1, 3)[:8000]
    elif scene == "off_image":  # rows beyond the FOV and zero points
        pts[::3, 2] = np.abs(pts[::3, 2]) * 3.0
        pts[::7] = 0.0
    chan = np.concatenate([pts, rng.normal(size=(len(pts), 2)).astype(np.float32)], -1)[None]
    proj_j, proj_t = jp.SphericalProjector(), tp.SphericalProjector()
    ref = proj_j.build_projection_map(jnp.asarray(pts[None]), jnp.asarray(chan[..., 3:]))
    got = proj_t.build_projection_map(T(pts[None]), T(chan[..., 3:]))
    assert got.shape == (1, 64, 720, 5)
    assert np.array_equal(N(got), N(ref))


def test_vmap_helpers_and_density_projector(rng):
    vm = jp.SphericalProjector().build_projection_map(jnp.asarray(ring_cloud(rng)[None]))
    vt = T(vm)
    np.testing.assert_array_equal(N(tp.vmap_depth(vt)), N(jp.vmap_depth(vm)))
    np.testing.assert_array_equal(N(tp.vmap_mask(vt)), N(jp.vmap_mask(vm)))
    for a, b in zip(tp.vmap_to_points(vt), jp.vmap_to_points(vm)):
        np.testing.assert_array_equal(N(a), N(b))
    for n in (256, 1024, 2048, 4095, 4096, 8192, 100000):
        ref = jp.density_matched_projector(n)
        assert tp.density_matched_projector(n) == tp.SphericalProjector(
            ref.height, ref.width, ref.min_vertical_fov, ref.max_vertical_fov)


# the default-lane scenarios of tests/test_projection.py, on the port


def test_pixel_coords_in_bounds(rng):
    pts = T(ring_cloud(rng, rmax=50.0)[None])
    row, col, r = tp.SphericalProjector().project(pts)
    assert torch.all(row >= 0) and torch.all(row <= 64)
    assert torch.all(col >= 0) and torch.all(col <= 720)
    np.testing.assert_allclose(N(r)[0], np.linalg.norm(N(pts)[0], axis=-1), atol=1e-5)


def test_zbuffer_nearest_wins_and_ties_are_stable():
    p_near = np.array([10.0, 0.0, -1.0])
    pts = T(np.stack([p_near * 3.0, p_near])[None].astype(np.float32))
    vm = N(tp.SphericalProjector().build_projection_map(pts))[0]
    nz = vm[np.linalg.norm(vm, axis=-1) > 0]
    assert nz.shape == (1, 3)
    np.testing.assert_allclose(nz[0], p_near, atol=1e-5)
    same = T(np.stack([p_near] * 3)[None].astype(np.float32))
    assert torch.equal(tp.SphericalProjector().build_projection_map(same),
                       tp.SphericalProjector().build_projection_map(same))


def test_roundtrip_points_survive(rng):
    pts_np = ring_cloud(rng, 2000, rmax=50.0)
    flat, mask = tp.vmap_to_points(tp.SphericalProjector().build_projection_map(T(pts_np[None])))
    got = N(flat)[0][N(mask)[0] > 0]
    d = np.abs(got[:, None, :] - pts_np[None, :, :]).sum(-1).min(1)
    assert d.max() < 1e-4 and got.shape[0] > 1000


# --- geometry ----------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_vertex_map():
    """A dense 64x720 scan of the corridor world, stretched to KITTI's
    reach (ranges up to ~80 m)."""
    scans, _ = generate_sequence(SyntheticSequenceConfig(
        n_frames=1, seed=2, num_beams=64, num_cols=720, dropout=0.0, num_points=46080))
    return np.asarray(jp.SphericalProjector().build_projection_map(jnp.asarray(scans[:1] * 1.05)))


def test_box_filter_sum_is_bit_equal(dense_vertex_map):
    xyz = dense_vertex_map[..., :3]
    outer = (xyz[..., :, None] * xyz[..., None, :]).reshape(xyz.shape[:3] + (9,))
    for img in (xyz, outer):
        for k in (3, 5):
            assert np.array_equal(N(tg.box_filter_sum(T(img), k)),
                                  N(jg.box_filter_sum(jnp.asarray(img), k)))


def _normals_f64(vm: np.ndarray) -> np.ndarray:
    xyz = T(vm[..., :3]).double()
    b, h, w = xyz.shape[:3]
    m = tg.box_filter_sum((xyz[..., :, None] * xyz[..., None, :]).reshape(b, h, w, 9), 5)
    n = torch.linalg.solve_ex(m.reshape(b, h, w, 3, 3), tg.box_filter_sum(xyz, 5)[..., None])[0][..., 0]
    return (n / torch.linalg.norm(n, dim=-1, keepdim=True)).numpy()


def test_normal_map_against_reference_at_kitti_scale(dense_vertex_map):
    vm = dense_vertex_map
    assert np.linalg.norm(vm[..., :3], axis=-1).max() > 75.0
    ref = np.asarray(jg.compute_normal_map(jnp.asarray(vm), 5))
    got = N(tg.compute_normal_map(T(vm), 5))
    ok = np.linalg.norm(ref, axis=-1) > 0.5
    # the same pixels get a normal
    assert np.array_equal(ok, np.linalg.norm(got, axis=-1) > 0.5)
    gap = np.abs(got - ref).max(-1)[ok]
    assert np.median(gap) < 1e-4 and np.quantile(gap, 0.99) < 0.05, (
        np.median(gap), np.quantile(gap, 0.99))
    # against the float64 solution of the same map, sign-free: the port is
    # no further off than the reference
    exact = _normals_f64(vm)[ok]
    err_ref = 1.0 - np.abs(np.sum(ref[ok] * exact, -1))
    err_got = 1.0 - np.abs(np.sum(got[ok] * exact, -1))
    for q in (0.5, 0.9, 0.99):
        assert np.quantile(err_got, q) <= 1.5 * np.quantile(err_ref, q) + 1e-7, q


def test_normal_map_flat_ground():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 20, size=(4000, 2))
    keep = np.linalg.norm(xy, axis=-1) > 4.0
    pts = np.concatenate([xy[keep], np.full((keep.sum(), 1), -1.7)], -1).astype(np.float32)
    vmap = tp.SphericalProjector().build_projection_map(T(pts[None]))
    normals = N(tg.compute_normal_map(vmap, kernel_size=5))[0]
    valid = np.linalg.norm(normals, axis=-1) > 0.5
    assert valid.sum() > 100
    assert np.quantile(np.abs(normals[valid][:, 2]), 0.25) > 0.95


def test_compute_neighbors_and_orientation_match_reference(rng):
    h, w, d = 8, 16, 4
    tgt = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    ref = rng.normal(size=(d, h, w, 3)).astype(np.float32)
    ref[rng.uniform(size=(d, h, w)) < 0.3] = 0.0
    ref[:, 0, 0] = 0.0
    tgt[0, 1, 1] = 0.0
    fields = rng.normal(size=(d, h, w, 2)).astype(np.float32)
    a = jg.compute_neighbors(jnp.asarray(tgt), jnp.asarray(ref), jnp.asarray(fields))
    b = tg.compute_neighbors(T(tgt), T(ref), T(fields))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(N(y), N(x))
    n = rng.normal(size=(100, 3)).astype(np.float32)
    p = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        N(tg.orient_normals_towards_origin(T(p), T(n))),
        N(jg.orient_normals_towards_origin(jnp.asarray(p), jnp.asarray(n))))


def test_compute_neighbors_picks_closest():
    h, w = 4, 4
    tgt = np.zeros((1, h, w, 3), np.float32)
    tgt[0, 1, 1] = [1.0, 1.0, 1.0]
    ref = np.zeros((3, h, w, 3), np.float32)
    ref[0, 1, 1] = [5.0, 5.0, 5.0]
    ref[1, 1, 1] = [1.1, 1.0, 1.0]  # closest
    fields = np.zeros((3, h, w, 2), np.float32)
    fields[1, 1, 1] = [7.0, 8.0]
    nbrs, f = tg.compute_neighbors(T(tgt), T(ref), T(fields))
    np.testing.assert_allclose(N(nbrs)[0, 1, 1], [1.1, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(N(f)[0, 1, 1], [7.0, 8.0], atol=1e-6)
    assert np.all(N(nbrs)[0, 0, 0] == 0)


def test_estimate_timestamps_monotonic_over_sweep():
    az = np.linspace(np.pi - 1e-3, -np.pi + 1e-3, 100)
    frac = N(tg.estimate_timestamps(T(np.stack([np.cos(az), np.sin(az), np.zeros(100)], -1))))
    assert np.all(np.diff(frac) > 0) and frac[0] < 0.01 and frac[-1] > 0.99


def test_timestamps_and_pixel_grid_match_reference(rng):
    pts = ring_cloud(rng, 500)
    for cw in (True, False):
        np.testing.assert_allclose(N(tg.estimate_timestamps(T(pts), cw)),
                                   N(jg.estimate_timestamps(jnp.asarray(pts), cw)), atol=1e-6)
    np.testing.assert_array_equal(N(tg.pixel_grid(5, 7)), N(jg.pixel_grid(5, 7)))


# --- optimization --------------------------------------------------------------


@pytest.mark.parametrize("scheme", jopt.LS_SCHEMES)
def test_robust_cost_and_weights_match_reference(rng, scheme):
    r = (rng.normal(size=1000) * 0.5).astype(np.float32)
    md = np.abs(rng.normal(size=1000)).astype(np.float32)
    for sigma in (0.5, np.float32(0.1)):
        kw = dict(match_distances=md) if scheme == "neighborhood" else {}
        tkw = dict(match_distances=T(md)) if scheme == "neighborhood" else {}
        sj = sigma if isinstance(sigma, float) else jnp.float32(sigma)
        np.testing.assert_allclose(
            N(topt.robust_cost(T(r), scheme, sigma, **tkw)),
            N(jopt.robust_cost(jnp.asarray(r), scheme, sj, **kw)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            N(topt.robust_weights(T(r), scheme, sigma, **tkw)),
            N(jopt.robust_weights(jnp.asarray(r), scheme, sj, **kw)), rtol=1e-6, atol=1e-7)


def _problem(rng, b=2, n=600, scale=30.0, twist_scale=0.05, dtype=np.float32):
    points = (rng.normal(size=(b, n, 3)) * scale).astype(dtype)
    normals = rng.normal(size=(b, n, 3))
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(dtype)
    gt = np.asarray(jse3.exp(jnp.asarray((rng.normal(size=(b, 6)) * twist_scale).astype(dtype))))
    target = np.asarray(jse3.transform(jnp.asarray(gt), jnp.asarray(points)))
    target = (target + rng.normal(size=target.shape) * 0.02).astype(dtype)  # noisy
    return points, target, normals, gt


def test_residual_jacobians_match_reference(rng):
    src, tgt, nrm, _ = _problem(rng)
    pose = np.asarray(jse3.exp(jnp.asarray((rng.normal(size=(2, 6)) * 0.05).astype(np.float32))))
    mask = (rng.uniform(size=(2, 600)) > 0.2).astype(np.float32)
    a = jopt.point_to_plane_residual_jac(*map(jnp.asarray, (pose, src, tgt, nrm)), jnp.asarray(mask))
    b = topt.point_to_plane_residual_jac(*map(T, (pose, src, tgt, nrm)), T(mask))
    for x, y in zip(a, b):
        np.testing.assert_allclose(N(y), N(x), atol=1e-4, rtol=1e-5)
    a = jopt.point_to_point_residual_jac(*map(jnp.asarray, (pose, src, tgt)), jnp.asarray(mask))
    b = topt.point_to_point_residual_jac(*map(T, (pose, src, tgt)), T(mask))
    for x, y in zip(a, b):
        np.testing.assert_allclose(N(y), N(x), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_gauss_newton_se3_matches_reference_at_kitti_scale(rng, kind):
    src, tgt, nrm, gt = _problem(rng, scale=30.0)
    kw = dict(max_iters=8, norm_stop_criterion=1e-6, scheme="huber", sigma=0.1)
    if kind == "plane":
        ref = jopt.solve_point_to_plane(*map(jnp.asarray, (src, tgt, nrm)), **kw)
        got = topt.solve_point_to_plane(*map(T, (src, tgt, nrm)), **kw)
    else:
        ref = jopt.solve_point_to_point(*map(jnp.asarray, (src, tgt)), **kw)
        got = topt.solve_point_to_point(*map(T, (src, tgt)), **kw)
    np.testing.assert_allclose(N(got.pose), N(ref.pose), atol=1e-5)
    np.testing.assert_allclose(N(got.cost), N(ref.cost), rtol=1e-3)
    np.testing.assert_array_equal(N(got.num_iters), N(ref.num_iters))
    np.testing.assert_allclose(N(got.pose), gt, atol=5e-3)


def test_singular_system_gives_non_finite_not_an_exception():
    h = torch.zeros(1, 6, 6)
    g = torch.ones(1, 6)
    dx = topt.damped_step(h, g, 0.0)
    assert not torch.all(torch.isfinite(dx))


# the default-lane scenarios of tests/test_optimization.py, on the port


def _make_problem(rng, b=3, n=400, twist_scale=0.1):
    """tests/test_optimization.py's problem, draw for draw (float64)."""
    points = rng.normal(size=(b, n, 3)).astype(np.float64) * 10.0
    normals = rng.normal(size=(b, n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    gt_twist = rng.normal(size=(b, 6)) * twist_scale
    gt_pose = np.asarray(jse3.exp(jnp.asarray(gt_twist)))
    target = np.asarray(jse3.transform(jnp.asarray(gt_pose), jnp.asarray(points)))
    return points, target, normals, gt_pose


def test_point_to_plane_and_point_recover_perturbation(rng):
    src, tgt, nrm, gt = _make_problem(rng)
    res = topt.solve_point_to_plane(T(src), T(tgt), T(nrm), max_iters=15, norm_stop_criterion=1e-10)
    np.testing.assert_allclose(N(res.pose), gt, atol=1e-7)
    assert np.all(N(res.cost) < 1e-12)
    res = topt.solve_point_to_point(T(src), T(tgt), max_iters=15, norm_stop_criterion=1e-10)
    np.testing.assert_allclose(N(res.pose), gt, atol=1e-7)


def test_generic_gauss_newton_additive():
    t = torch.linspace(0.0, 1.0, 50, dtype=torch.float64)
    y = 2.0 * torch.exp(-1.3 * t)

    def residual(x):
        return x[:, 0:1] * torch.exp(x[:, 1:2] * t[None]) - y[None]

    res = topt.gauss_newton(residual, torch.tensor([[1.0, 0.0]], dtype=torch.float64),
                            max_iters=30, norm_stop_criterion=1e-12)
    np.testing.assert_allclose(N(res.x[0]), [2.0, -1.3], atol=1e-6)


def test_robust_schemes_reject_outliers(rng):
    src, tgt, nrm, gt = _make_problem(rng, b=1, n=500, twist_scale=0.05)
    bad = np.array(tgt)
    idx = rng.choice(500, size=50, replace=False)
    bad[0, idx] += rng.normal(size=(50, 3)) * 20.0
    plain = topt.solve_point_to_plane(T(src), T(bad), T(nrm), max_iters=20)
    robust = topt.solve_point_to_plane(T(src), T(bad), T(nrm), max_iters=40,
                                       scheme="geman_mcclure", sigma=0.2, norm_stop_criterion=1e-9)
    err_plain = np.abs(N(plain.pose) - gt).max()
    err_robust = np.abs(N(robust.pose) - gt).max()
    assert err_robust < err_plain * 0.1 and err_robust < 1e-3


def test_mask_excludes_points(rng):
    src, tgt, nrm, gt = _make_problem(rng, b=1, n=200, twist_scale=0.05)
    poisoned = np.array(tgt)
    poisoned[0, 100:] = 1e6
    mask = np.concatenate([np.ones(100), np.zeros(100)])[None]
    res = topt.solve_point_to_plane(T(src), T(poisoned), T(nrm), mask=T(mask), max_iters=15,
                                    norm_stop_criterion=1e-10)
    np.testing.assert_allclose(N(res.pose), gt, atol=1e-6)


# --- local map (projective half) -------------------------------------------------


def test_insert_keyframe_fifo_and_skip_match_reference():
    js, ts = jlm.init_local_map(3, 128), tlm.init_local_map(3, 128)
    for i in range(5):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = float(i)
        pts = np.full((128, 3), i + 1.0, np.float32)
        ok = (np.arange(128) % (i + 2) > 0).astype(np.float32)
        ins = i != 2  # frame 2 is skipped
        js = jlm.insert_keyframe(js, jnp.asarray(pts), jnp.asarray(-pts), jnp.asarray(ok),
                                 jnp.asarray(pose), jnp.asarray(ins))
        ts = tlm.insert_keyframe(ts, T(pts), T(-pts), T(ok), T(pose), torch.tensor(ins))
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(N(b), N(a))
            assert N(b).dtype == N(a).dtype
    assert int(ts.next_slot) == 4 and float(ts.valid.sum()) == 3.0


def test_build_model_transforms_to_query_frame():
    state = tlm.init_local_map(2, 500)
    rng = np.random.default_rng(0)
    pts = np.stack([np.full(500, 20.0), rng.uniform(-5, 5, 500), rng.uniform(-2, 2, 500)],
                   -1).astype(np.float32)
    normals = np.tile([-1.0, 0, 0], (500, 1)).astype(np.float32)
    state = tlm.insert_keyframe(state, T(pts), T(normals), torch.ones(500), torch.eye(4),
                                torch.tensor(True))
    query = torch.eye(4)
    query[0, 3] = 5.0
    model = N(tlm.build_model_map(state, query, tp.SphericalProjector()))
    occ = np.linalg.norm(model[..., :3], axis=-1) > 0
    assert occ.sum() > 100
    np.testing.assert_allclose(model[..., 0][occ].mean(), 15.0, atol=0.5)
    np.testing.assert_allclose(model[..., 3][occ], -1.0, atol=1e-6)


@pytest.fixture(scope="module")
def carried_map(scans4096):
    """The reference's state after six frames of the sequence."""
    scans, _ = scans4096
    odo = jicp.ICPOdometry(jicp.ICPConfig(num_points=4096))
    odo.init()
    odo.process_sequence(scans[:6])
    return odo.state


def test_model_map_and_association_match_reference(carried_map, scans4096):
    scans, _ = scans4096
    st = carried_map
    tst = tlm.LocalMapState(*(T(x) for x in st.map))
    proj_j, proj_t = jp.density_matched_projector(4096), tp.density_matched_projector(4096)
    query = np.asarray(st.pose) @ np.asarray(st.last_rel)
    pj, nj, vj = jlm.flatten_map_points(st.map, jnp.asarray(query))
    pt, nt, vt = tlm.flatten_map_points(tst, T(query))
    np.testing.assert_allclose(N(pt), N(pj), atol=2e-5)
    np.testing.assert_allclose(N(nt), N(nj), atol=1e-6)
    np.testing.assert_array_equal(N(vt), N(vj))
    ref = np.asarray(jlm.build_model_map(st.map, jnp.asarray(query), proj_j))
    got = N(tlm.build_model_map(tst, T(query), proj_t))
    # points transformed with and without fused multiply-adds differ in the
    # last bits, which can move a point across a pixel or depth tie
    same = np.all(got == ref, axis=-1) | np.all(np.abs(got - ref) < 2e-5, axis=-1)
    assert same.mean() > 0.999, same.mean()
    # association on one model is exact
    pts = scans[6]
    a = jlm.associate(jnp.asarray(ref), jnp.asarray(pts), proj_j, 0.5)
    b = tlm.associate(T(ref), T(pts), proj_t, 0.5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(N(y), N(x))
    assert float(N(b[2]).sum()) > 500


# --- the odometry ---------------------------------------------------------------


def _carry_and_step(tmp_path, scans, kw, n_before=6):
    """Run the reference over the first frames, snapshot, restore into both,
    step once on the next frame; returns (reference result, port result,
    port driver)."""
    ref = jicp.ICPOdometry(jicp.ICPConfig(**kw))
    ref.init()
    ref.process_sequence(scans[:n_before])
    path = str(tmp_path / "state.npz")
    ref.snapshot(path)
    ref.process_next_frame(scans[n_before])
    port = ticp.ICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    port.restore(path)
    assert len(port.results) == n_before
    port.process_next_frame(scans[n_before])
    return ref.results[-1], port.results[-1], port


@pytest.mark.parametrize("kw", [{}, {"bev_bootstrap": True}], ids=["projective", "bev_bootstrap"])
def test_one_step_from_a_carried_state_matches_reference(tmp_path, scans4096, kw):
    scans, _ = scans4096
    ref, got, port = _carry_and_step(tmp_path, scans, dict(num_points=4096, **kw))
    np.testing.assert_allclose(got.pose, np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_allclose(got.rel_pose, np.asarray(ref.rel_pose), atol=1e-5)
    assert abs(float(got.num_matches) - float(ref.num_matches)) <= 2
    np.testing.assert_allclose(float(got.icp_cost), float(ref.icp_cost), rtol=1e-3)
    assert bool(got.inserted_keyframe) == bool(ref.inserted_keyframe)
    assert port.iterations[0] > 1 and port.host_reads[0] <= port.iterations[0] + 1


def _run_ref(kw, scans):
    odo = jicp.ICPOdometry(jicp.ICPConfig(**kw))
    odo.init()
    odo.process_sequence(scans)
    return odo.absolute_poses()


def test_sequence_matches_reference(scans4096):
    scans, gt = scans4096
    kw = dict(num_points=4096)
    ref = _run_ref(kw, scans)
    # the reference's own sensitivity: its chain on the scans moved by one
    # float32 ulp, up and down
    sens = 0.0
    for direction in (np.inf, -np.inf):
        nudged = np.where(scans != 0, np.nextafter(scans, np.float32(direction)), 0.0)
        sens = max(sens, np.abs(_run_ref(kw, nudged.astype(np.float32))[:, :3, 3]
                                - ref[:, :3, 3]).max())
    port = ticp.ICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    port.init()
    for scan in scans:
        port.process_next_frame(scan)
    got = port.absolute_poses()
    gap = np.abs(got[:, :3, 3] - ref[:, :3, 3]).max()
    assert gap <= max(1e-3, 3.0 * sens), (gap, sens)
    assert np.abs(got[:, :3, :3] - ref[:, :3, :3]).max() <= max(1e-3, 3.0 * sens)
    for pred in (ref, got):
        ate, _ = metrics.compute_ate(metrics.compute_relative_poses(pred),
                                     metrics.compute_relative_poses(gt))
        assert ate < 0.02 and np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3]) < 0.15


def test_process_sequence_equals_frame_by_frame(scans4096):
    scans, _ = scans4096
    cfg = ticp.ICPConfig(num_points=4096)
    a = ticp.ICPOdometry(cfg, device="cpu")
    a.init()
    for scan in scans[:4]:
        a.process_next_frame(scan)
    b = ticp.ICPOdometry(cfg, device="cpu")
    b.init()
    poses = b.process_sequence(scans[:4])
    np.testing.assert_array_equal(poses, a.absolute_poses())
    np.testing.assert_array_equal(b.relative_poses(), a.relative_poses())
    assert b.iterations == a.iterations
    assert sum(b.host_reads) == sum(a.host_reads) - 3  # one fetch instead of four


def test_lazy_model_rebuild_step_matches_reference(tmp_path, scans4096):
    scans, _ = scans4096
    kw = dict(num_points=4096, model_rebuild_trans=4.0, model_rebuild_rot=5.0, map_stride=2)
    ref, got, _ = _carry_and_step(tmp_path, scans, kw)
    np.testing.assert_allclose(got.pose, np.asarray(ref.pose), atol=1e-5)
    assert abs(float(got.num_matches) - float(ref.num_matches)) <= 2


# the default-lane scenarios of tests/test_icp_odometry.py, on the port


def test_first_frame_is_identity_and_stationary_scans_give_identity(scans4096):
    scans, _ = scans4096
    odo = ticp.ICPOdometry(ticp.ICPConfig(num_points=4096), device="cpu")
    odo.init()
    np.testing.assert_allclose(odo.process_next_frame(scans[0]), np.eye(4), atol=1e-6)
    assert bool(odo.results[0].inserted_keyframe)
    odo.process_next_frame(scans[0])
    np.testing.assert_allclose(odo.results[-1].rel_pose, np.eye(4), atol=5e-3)


def test_arbitrary_scan_sizes_padded(scans4096):
    scans, _ = scans4096
    odo = ticp.ICPOdometry(ticp.ICPConfig(num_points=2048), device="cpu")
    odo.init()
    odo.process_next_frame(scans[0][:1500])
    odo.process_next_frame(scans[1])
    assert len(odo.results) == 2 and np.all(np.isfinite(odo.absolute_poses()))
    for m, seed in ((1500, 0), (4096, 1), (2048, 2)):
        pts = scans[1][:m]
        np.testing.assert_array_equal(ticp.fix_scan_size(pts, 2048, seed),
                                      jicp.fix_scan_size(pts, 2048, seed))


def test_int16_transfer_matches_reference_and_drops_out_of_range():
    jc = jicp.ICPConfig(transfer_dtype="int16", transfer_scale=0.003)
    tc = ticp.ICPConfig(transfer_dtype="int16", transfer_scale=0.003)
    pts = np.array([[1.0, 2.0, 3.0], [500.0, 0.0, 0.0], [-7.25, 0.5, 90.0]], np.float32)
    q = ticp.quantize_scans(tc, pts)
    np.testing.assert_array_equal(q, jicp.quantize_scans(jc, pts))
    assert q.dtype == np.int16 and np.all(q[1] == 0)
    np.testing.assert_array_equal(N(ticp.dequantize_scans(tc, T(q))),
                                  N(jicp.dequantize_scans(jc, jnp.asarray(q))))


def test_config_defaults_match_reference():
    ref, got = jicp.ICPConfig(), ticp.ICPConfig()
    for field in jicp.ICPConfig.__dataclass_fields__:
        a, b = getattr(ref, field), getattr(got, field)
        if field == "projector":
            assert (a.height, a.width, a.min_vertical_fov, a.max_vertical_fov) == (
                b.height, b.width, b.min_vertical_fov, b.max_vertical_fov)
        else:
            assert a == b, field


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ticp.ICPOdometry(ticp.ICPConfig(num_points=256))
    with pytest.raises(RuntimeError, match="CUDA"):
        ticp.init_state(ticp.ICPConfig(num_points=256))


def test_step_turns_tf32_off_and_restores_the_flags(scans4096):
    scans, _ = scans4096
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    orig = topt.normal_equations

    def spy(wjac, wres):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return orig(wjac, wres)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        topt.normal_equations = spy
        cfg = ticp.ICPConfig(num_points=4096)
        ticp.process_frame(cfg, ticp.init_state(cfg, device="cpu"), T(scans[0]))
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        topt.normal_equations = orig
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_se3_helpers_used_by_the_step_match_reference(rng):
    tw = (rng.normal(size=(5, 6)) * 0.2).astype(np.float32)
    pose = np.asarray(jse3.exp(jnp.asarray(tw)))
    np.testing.assert_allclose(N(tse3.normalize(T(pose))), np.asarray(jse3.normalize(jnp.asarray(pose))),
                               atol=1e-6)
    np.testing.assert_allclose(N(ticp._normalize_or_nan(T(pose[0]))),
                               np.asarray(jse3.normalize(jnp.asarray(pose[0]))), atol=1e-6)
    bad = pose[0].copy()
    bad[0, 0] = np.nan
    assert torch.all(torch.isnan(ticp._normalize_or_nan(T(bad))))
