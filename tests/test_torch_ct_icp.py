"""Continuous-time ICP odometry of the port against the JAX reference on the
CPU: the per-point warp, the 12-dof Gauss-Newton (elastic and rigid), one
step from a state carried across (frame 1 included, where the bootstrap
keyframe is repaired), the timestamp-free path, and a motion-distorted
sequence. The same float32 numpy inputs, made from a seed, go through both.

Tolerances, and why:
- warped points to 2e-5 m at up to 80 m (a few float32 ulps);
- one Gauss-Newton solve from the same inputs to 1e-5 (pose), 2 matches
  and 1e-3 relative cost: the same ops summed in another order;
- one step from a state carried across: the reference's own step moves
  when its state's poses and the scan move by one float32 ulp (by 2 cm on
  this sequence's frame 2, where four matches flip), so each step is held
  to 3x that sensitivity (at least 1e-5), and, where that is under 1e-5
  (frames 0 and 1, the repair), the keyframe's points to 2e-5 m; their
  per-point normals come from a sparse 32x512 vertex map,
  where ~1 % of them flip sign or fall under the 0.5 norm gate, so the
  point validity is held by its share (98 %);
- the sequence: the port's chain is held to 3x the reference's own
  one-ulp sensitivity (at least 1e-3), as the ICP chain of
  test_torch_icp.py is; tests/test_ct_icp.py's accuracy gates hold at its
  own size (8192 points, 12 frames; ``slow``, as the reference marks them).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.data.synthetic import (
    SyntheticSequenceConfig,
    generate_sequence_with_times,
)
from pwclonet_pylidarslam_torch.slam import CTICPConfig, CTICPOdometry
from pwclonet_pylidarslam_torch.slam import ct_icp_odometry as tct
from pwclonet_pylidarslam_torch.slam import local_map as tlm
from pwclonet_pylidarslam_torch.slam.icp_odometry import StepStats
from pwclonet_pylidarslam_tpu.core import se3 as jse3
from pwclonet_pylidarslam_tpu.slam import ct_icp_odometry as jct
from pwclonet_pylidarslam_tpu.slam import local_map as jlm

NP = 2048


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This file's many small tensor ops run on one thread: with several test
    workers on one machine, torch's thread pool per worker oversubscribes
    the cores and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drift(pred: np.ndarray, gt: np.ndarray) -> float:
    """Final-position error over trajectory length (tests/test_ct_icp.py)."""
    drift = float(np.linalg.norm(pred[-1][:3, 3] - gt[-1][:3, 3]))
    return drift / max(float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1).sum()), 1e-9)


@pytest.fixture(scope="module")
def distorted():
    """tests/test_ct_icp.py's motion (curve, 2.5 m and 2 deg a frame, seed
    3, rolling shutter) at 6 frames of 2048 points."""
    return generate_sequence_with_times(SyntheticSequenceConfig(
        n_frames=6, trajectory="curve", speed=2.5, yaw_rate_deg=2.0, seed=3,
        motion_distortion=True, num_points=NP))


@pytest.fixture(scope="module")
def ref_frames(distorted):
    """The reference run frame by frame: the state before each frame and
    each frame's result, with and without timestamps."""
    scans, times, _ = distorted
    out = {}
    for label, ts in (("times", times), ("no_times", None)):
        odo = jct.CTICPOdometry(jct.CTICPConfig(num_points=NP))
        odo.init()
        states = []
        for t in range(len(scans)):
            states.append(jax.tree.map(np.array, odo.state))  # the step donates it
            odo.process_next_frame(scans[t], None if ts is None else ts[t])
        states.append(jax.tree.map(np.array, odo.state))
        out[label] = (states, list(odo.results))
    return out


def _port_state(ref_state) -> tct.CTOdometryState:
    leaves = {f: getattr(ref_state, f) for f in jct.CTOdometryState._fields}
    return tct.CTOdometryState(
        map=tlm.LocalMapState(*(T(x) for x in leaves.pop("map"))),
        frame_idx=int(leaves.pop("frame_idx")),
        **{f: T(x) for f, x in leaves.items()},
    )


def _assert_result(got: tct.CTFrameResult, ref, atol=1e-5, matches=2):
    """Poses to ``atol``; matches within ``matches`` and the cost to 1e-3
    relative, unless ``matches`` is None (a step whose matches flip)."""
    for field in ("pose", "begin_pose", "rel_pose"):
        np.testing.assert_allclose(N(getattr(got, field)), np.asarray(getattr(ref, field)),
                                   atol=atol, err_msg=field)
    if matches is not None:
        assert abs(float(got.num_matches) - float(ref.num_matches)) <= matches
        np.testing.assert_allclose(float(got.icp_cost), float(ref.icp_cost), rtol=1e-3)
    assert bool(got.inserted_keyframe) == bool(ref.inserted_keyframe)


def test_ct_warp_matches_reference(rng):
    tw = (rng.normal(size=(2, 6)) * np.array([1.0, 1.0, 0.2, 0.02, 0.02, 0.05])).astype(np.float32)
    a, b = (np.asarray(jse3.exp(jnp.asarray(x))) for x in tw)
    pts = (rng.normal(size=(3000, 3)) * 30).astype(np.float32)
    alphas = rng.uniform(0, 1, 3000).astype(np.float32)
    ref = np.asarray(jct._ct_warp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alphas),
                                  jnp.asarray(pts)))
    got = N(tct._ct_warp(T(a), T(b), T(alphas), T(pts)))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # the end points of the geodesic: alpha 0 is a, alpha 1 is b
    ends = N(tct._ct_warp(T(a), T(b), torch.tensor([0.0, 1.0]), T(pts[:2])))
    np.testing.assert_allclose(ends[0], a[:3, :3] @ pts[0] + a[:3, 3], atol=2e-5)
    np.testing.assert_allclose(ends[1], b[:3, :3] @ pts[1] + b[:3, 3], atol=2e-5)


@pytest.mark.parametrize("elastic", [True, False], ids=["elastic", "rigid"])
def test_register_ct_from_one_state_matches_reference(distorted, ref_frames, elastic):
    scans, times, _ = distorted
    t = 3
    st = ref_frames["times"][0][t]
    cfg_j = jct.CTICPConfig(num_points=NP, elastic=elastic)
    cfg_t = tct.CTICPConfig(num_points=NP, elastic=elastic)
    pts = scans[t]
    valid = (np.linalg.norm(pts, axis=-1) > 1e-3).astype(np.float32)
    alphas = np.clip(times[t], 0, 1) * valid
    predicted = np.asarray(st.end_pose) @ np.asarray(st.last_rel)
    a_init = np.linalg.inv(np.asarray(st.last_rel)).astype(np.float32)
    model = np.asarray(jlm.build_model_map(st.map, jnp.asarray(predicted), cfg_j.projector))
    ref = jct._register_ct(cfg_j, jnp.asarray(model), jnp.asarray(pts), jnp.asarray(alphas),
                           jnp.asarray(a_init), jnp.asarray(valid))
    stats = StepStats()
    got = tct._register_ct(cfg_t, T(model), T(pts), T(alphas), T(a_init), T(valid), stats)
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(N(got[1]), np.asarray(ref[1]), atol=1e-5)
    assert abs(float(got[2]) - float(ref[2])) <= 2 and float(got[2]) > 200
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=1e-3)
    # reads only from the gate's floor on (iteration index 3), one an iteration
    assert stats.iterations >= 4 and stats.host_reads <= stats.iterations - 3


_REF_STEP = jax.jit(lambda s, p, ts: jct.process_frame(jct.CTICPConfig(num_points=NP), s, p, ts))


def _nudged(x: np.ndarray, direction: float) -> np.ndarray:
    return np.where(x != 0, np.nextafter(x, np.float32(direction)), 0.0).astype(np.float32)


def _step_sensitivity(state, scan, times) -> float:
    """How far the reference's step moves (begin and end pose) when its
    state's poses and the scan move by one float32 ulp, up and down."""
    step = _REF_STEP
    base = step(jax.tree.map(jnp.asarray, state), jnp.asarray(scan), times)[1]
    gap = 0.0
    for d in (np.inf, -np.inf):
        moved = state._replace(end_pose=_nudged(state.end_pose, d),
                               last_rel=_nudged(state.last_rel, d),
                               map=state.map._replace(poses=_nudged(state.map.poses, d)))
        r = step(jax.tree.map(jnp.asarray, moved), jnp.asarray(_nudged(scan, d)), times)[1]
        gap = max(gap, *(float(np.abs(np.asarray(getattr(r, f)) - np.asarray(getattr(base, f))).max())
                         for f in ("pose", "begin_pose")))
    return gap


@pytest.mark.parametrize("t", [0, 1, 2, 4])
def test_one_step_from_a_carried_state_matches_reference(distorted, ref_frames, t):
    """Frame 0 (empty map), frame 1 (slot 0 repaired with the solved
    velocity), and later frames."""
    scans, times, _ = distorted
    states, results = ref_frames["times"]
    cfg = tct.CTICPConfig(num_points=NP)
    new_state, got = tct.process_frame(cfg, _port_state(states[t]), T(scans[t]), T(times[t]))
    sens = _step_sensitivity(states[t], scans[t], jnp.asarray(times[t]))
    _assert_result(got, results[t], atol=max(1e-5, 3.0 * sens), matches=None if sens > 1e-4 else 2)
    ref_next = states[t + 1]
    filled = np.asarray(ref_next.map.valid) > 0
    np.testing.assert_allclose(N(new_state.map.poses), np.asarray(ref_next.map.poses),
                               atol=max(1e-5, 3.0 * sens))
    if sens < 1e-5:  # the keyframe's points, slot 0 above all (the frame-1 repair)
        np.testing.assert_allclose(N(new_state.map.points)[filled],
                                   np.asarray(ref_next.map.points)[filled], atol=2e-5)
        same = N(new_state.map.pt_valid)[filled] == np.asarray(ref_next.map.pt_valid)[filled]
        assert same.mean() > 0.98
    np.testing.assert_array_equal(N(new_state.map.valid), np.asarray(ref_next.map.valid))
    assert new_state.frame_idx == int(ref_next.frame_idx)
    np.testing.assert_array_equal(N(new_state.boot_scan), np.asarray(ref_next.boot_scan))
    np.testing.assert_array_equal(N(new_state.boot_alphas), np.asarray(ref_next.boot_alphas))


@pytest.mark.parametrize("t", [1, 3])
def test_timestamp_free_step_matches_reference(distorted, ref_frames, t):
    """Without timestamps both estimate them from the azimuth."""
    scans, _, _ = distorted
    states, results = ref_frames["no_times"]
    cfg = tct.CTICPConfig(num_points=NP)
    _, got = tct.process_frame(cfg, _port_state(states[t]), T(scans[t]))
    sens = _step_sensitivity(states[t], scans[t], None)
    _assert_result(got, results[t], atol=max(1e-5, 3.0 * sens), matches=None if sens > 1e-4 else 2)


def _run_ref(odo, scans, times):
    odo.init()
    odo.process_sequence(scans, times)
    return odo.absolute_poses()


@pytest.mark.parametrize("elastic", [True, False], ids=["elastic", "rigid"])
def test_sequence_matches_reference(distorted, elastic):
    scans, times, gt = distorted
    ref_odo = jct.CTICPOdometry(jct.CTICPConfig(num_points=NP, elastic=elastic))
    ref = _run_ref(ref_odo, scans, times)
    ref_begins = np.stack([np.asarray(r.begin_pose) for r in ref_odo.results])
    # the reference's own sensitivity: its chain on the scans moved by one
    # float32 ulp, up and down
    sens = max(np.abs(_run_ref(ref_odo, _nudged(scans, d), times)[:, :3, 3] - ref[:, :3, 3]).max()
               for d in (np.inf, -np.inf))
    port = CTICPOdometry(CTICPConfig(num_points=NP, elastic=elastic), device="cpu")
    port.init()
    for scan, ts in zip(scans, times):
        port.process_next_frame(scan, ts)
    got = port.absolute_poses()
    bound = max(1e-3, 3.0 * sens)
    assert np.abs(got[:, :3, 3] - ref[:, :3, 3]).max() <= bound, sens
    assert np.abs(got[:, :3, :3] - ref[:, :3, :3]).max() <= bound, sens
    assert abs(_drift(got, gt) - _drift(ref, gt)) <= bound / 10.0  # 12.5 m of path
    begins = np.stack([r.begin_pose for r in port.results])
    assert np.abs(begins[:, :3, 3] - ref_begins[:, :3, 3]).max() <= bound
    if not elastic:  # rigid: the begin pose stays at the previous end
        np.testing.assert_allclose(begins[1:], got[:-1], atol=1e-4)


def test_process_sequence_equals_frame_by_frame(distorted):
    """``process_sequence`` gives the frame-by-frame poses, with one fetch
    instead of one a frame."""
    scans, times, _ = distorted
    cfg = CTICPConfig(num_points=NP)
    a = CTICPOdometry(cfg, device="cpu")
    a.init()
    for scan, ts in zip(scans[:4], times[:4]):
        a.process_next_frame(scan, ts)
    b = CTICPOdometry(cfg, device="cpu")
    b.init()
    poses = b.process_sequence(scans[:4], times[:4])
    np.testing.assert_array_equal(poses, a.absolute_poses())
    np.testing.assert_array_equal(b.relative_poses(), a.relative_poses())
    assert b.iterations == a.iterations and min(a.iterations[1:]) >= 4
    assert sum(b.host_reads) == sum(a.host_reads) - 3


@pytest.mark.slow
def test_reference_accuracy_gates_at_full_size():
    """tests/test_ct_icp.py's gates (all ``slow`` there) on the port: 12
    frames at 8192 points, tracking, beating rigid-scan ICP on distorted
    data, the azimuth fallback, rigid mode, and pre-deskewed data."""
    from pwclonet_pylidarslam_torch.slam import ICPConfig, ICPOdometry

    scans, times, gt = generate_sequence_with_times(SyntheticSequenceConfig(
        n_frames=12, trajectory="curve", speed=2.5, yaw_rate_deg=2.0, seed=3,
        motion_distortion=True))

    def run(odo, *args):
        odo.init()
        odo.process_sequence(*args)
        return _drift(odo.absolute_poses(), gt)

    odo = CTICPOdometry(CTICPConfig(), device="cpu")
    ct = run(odo, scans, times)
    assert ct < 0.02
    ends = odo.absolute_poses()
    for t in range(2, len(ends)):  # continuity: begin of t near end of t-1
        assert np.linalg.norm(odo.results[t].begin_pose[:3, 3] - ends[t - 1][:3, 3]) < 0.25
    assert ct < run(ICPOdometry(ICPConfig(), device="cpu"), scans)
    assert run(CTICPOdometry(CTICPConfig(), device="cpu"), scans) < 0.03
    assert run(CTICPOdometry(CTICPConfig(elastic=False), device="cpu"), scans, times) < 0.10
    scans, times, gt = generate_sequence_with_times(SyntheticSequenceConfig(
        n_frames=10, trajectory="curve", speed=1.0, seed=5, motion_distortion=False))
    assert run(CTICPOdometry(CTICPConfig(elastic=False), device="cpu"), scans, times) < 0.01


def test_arbitrary_scan_sizes_and_fix_size_match_reference(distorted):
    scans, times, _ = distorted
    ref = jct.CTICPOdometry(jct.CTICPConfig(num_points=1024))
    for m in (700, 1024, 2048):
        for ts in (None, times[1][:m]):
            a = tct.fix_scan_size(scans[1][:m], ts, 1024)
            b = ref._fix_size(scans[1][:m], ts)
            np.testing.assert_array_equal(a[0], b[0])
            assert (a[1] is None) == (b[1] is None)
            if ts is not None:
                np.testing.assert_array_equal(a[1], b[1])
    odo = CTICPOdometry(CTICPConfig(num_points=1024), device="cpu")
    odo.init()
    odo.process_next_frame(scans[0][:700], times[0][:700])
    odo.process_next_frame(scans[1])
    assert len(odo.results) == 2 and np.all(np.isfinite(odo.absolute_poses()))
    np.testing.assert_allclose(odo.absolute_poses()[0], np.eye(4), atol=1e-6)


def test_config_defaults_match_reference():
    ref, got = jct.CTICPConfig(), tct.CTICPConfig()
    for field in jct.CTICPConfig.__dataclass_fields__:
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
        CTICPOdometry(CTICPConfig(num_points=256))
    with pytest.raises(RuntimeError, match="CUDA"):
        tct.init_state(CTICPConfig(num_points=256))


def test_step_turns_tf32_off_and_restores_the_flags(distorted):
    scans, times, _ = distorted
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    orig = tct._prior_blocks

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return orig(*args)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tct._prior_blocks = spy
        cfg = tct.CTICPConfig(num_points=NP)
        st, _ = tct.process_frame(cfg, tct.init_state(cfg, device="cpu"), T(scans[0]), T(times[0]))
        tct.process_frame(cfg, st, T(scans[1]), T(times[1]))
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        tct._prior_blocks = orig
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
