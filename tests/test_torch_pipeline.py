"""The SLAM pipeline and its runner in the port against the reference on the
CPU: the ``short_sequence`` cases of ``tests/test_pipeline.py`` (odometry
only and with the back end; the runner's result files, read back by the
reference's readers; a failing sequence; the gallery and player), snapshots
restored across implementations, the resync of every absolute pose, GPS
priors, the drift scenario's first ICP step from one state, and the
reference's drift scenario (``slow``).

Scans come from the port's generator at 4096 points (the reference test's
sequence, cut in width). The reference's pose chain moves by up to a
centimetre when its scans move by one float32 ulp (ROADMAP Queue C), so a
sequence is held to 3x that sensitivity, measured here; one step from one
carried state is held to 1e-5.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.slam import loop_closure as tlc
from pwclonet_pylidarslam_torch.slam import pipeline as tpipe
from pwclonet_pylidarslam_torch.slam import runner as trun
from pwclonet_pylidarslam_tpu.evaluation import metrics
from pwclonet_pylidarslam_tpu.evaluation.results import read_metrics_yaml, read_poses_txt
from pwclonet_pylidarslam_tpu.slam import icp_odometry as jicp
from pwclonet_pylidarslam_tpu.slam import loop_closure as jlc
from pwclonet_pylidarslam_tpu.slam import pipeline as jpipe


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread (the synthetic caster's among
    them): with several test workers on one machine, torch's thread pool
    per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POINTS = 4096
SMALL_GRAPH = dict(backend_max_nodes=16, backend_max_edges=32, backend_max_priors=8)


class _Source:
    def __init__(self, scans, gt, gps=None):
        self.scans, self.gt, self.gps = scans, gt, gps

    def __len__(self):
        return len(self.scans)

    def scan(self, idx):
        return self.scans[idx]

    def ground_truth(self):
        return self.gt

    def gps_poses(self):
        return self.gps


@pytest.fixture(scope="module")
def short_sequence():
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=10, trajectory="curve", speed=1.0, seed=3, num_points=POINTS), device="cpu")


def _slam_cfg(mod, **kw):
    icp_mod = jicp if mod is jpipe else ticp
    return mod.SLAMConfig(odometry=icp_mod.ICPConfig(num_points=POINTS), **kw)


def _port_slam(cfg, odometry=None):
    return tpipe.SLAM(cfg, odometry=odometry, device="cpu")


@pytest.fixture(scope="module")
def reference_run(short_sequence):
    """The reference SLAM with the back end over the sequence, and its own
    spread when the scans move by one float32 ulp up or down."""
    scans, _ = short_sequence
    slam = jpipe.SLAM(_slam_cfg(jpipe, with_backend=True, **SMALL_GRAPH))
    slam.init()
    for s in scans:
        slam.process_next_frame(s)
    ref = slam.absolute_poses()
    sens = 0.0
    for direction in (np.inf, -np.inf):
        nudged = np.where(scans != 0, np.nextafter(scans, np.float32(direction)), 0.0)
        odo = jicp.ICPOdometry(jicp.ICPConfig(num_points=POINTS))
        odo.init()
        odo.process_sequence(nudged.astype(np.float32))
        sens = max(sens, float(np.abs(odo.absolute_poses() - ref).max()))
    return slam, ref, sens


@pytest.mark.parametrize("with_backend", [False, True], ids=["odometry_only", "with_backend"])
def test_slam_matches_reference(short_sequence, reference_run, with_backend):
    scans, gt = short_sequence
    ref_slam, ref, sens = reference_run
    kw = SMALL_GRAPH if with_backend else {}
    slam = _port_slam(_slam_cfg(tpipe, with_backend=with_backend, **kw))
    slam.init()
    for s in scans:
        slam.process_next_frame(s)
    pred = slam.absolute_poses()
    assert pred.shape == gt.shape and np.all(np.isfinite(pred))
    gap = float(np.abs(pred - ref).max())
    assert gap <= max(1e-3, 3.0 * sens), (gap, sens)
    ate, _ = metrics.compute_ate(metrics.compute_relative_poses(pred),
                                 metrics.compute_relative_poses(gt))
    assert ate < 0.02
    if with_backend:  # graph nodes mirror the trajectory without loop closures
        assert len(slam.builder.poses) == len(ref_slam.builder.poses) == len(scans)
        assert len(slam.builder.edges) == len(scans) - 1
        for (i, j, m, info), (ri, rj, rm, rinfo) in zip(slam.builder.edges, ref_slam.builder.edges):
            assert (i, j) == (ri, rj)
            np.testing.assert_allclose(m, rm, atol=max(1e-3, 3.0 * sens))
            np.testing.assert_array_equal(info, rinfo)
        assert slam.optimizations == []  # no loop edge: nothing to optimize


def test_runner_writes_results_the_reference_reads(tmp_path, short_sequence):
    scans, gt = short_sequence
    runner = trun.SLAMRunner(trun.SLAMRunnerConfig(
        slam=_slam_cfg(tpipe), log_dir=str(tmp_path / "run"), save_every_frames=5), device="cpu")
    out = runner.run({"synth00": _Source(scans, gt)})
    md = out["synth00"]
    assert "ATE" in md and np.isfinite(md["ATE"]) and not runner.failures
    poses = read_poses_txt(str(tmp_path / "run" / "synth00.poses.txt"))
    assert poses.shape == (10, 4, 4)
    np.testing.assert_allclose(poses, runner.pipelines["synth00"].absolute_poses(), atol=1e-6)
    assert read_poses_txt(str(tmp_path / "run" / "synth00.partial.poses.txt")).shape == (10, 4, 4)
    ymetrics = read_metrics_yaml(str(tmp_path / "run" / "metrics.yaml"))
    assert set(ymetrics["synth00"]) >= {"tr_err", "rot_err", "ATE", "STD_ATE", "ARE", "STD_ARE"}
    np.testing.assert_allclose(ymetrics["synth00"]["ATE"], md["ATE"], rtol=1e-6)
    assert (tmp_path / "run" / "synth00_gt.poses.txt").exists()


def test_runner_survives_failing_sequence(tmp_path, short_sequence):
    scans, gt = short_sequence

    class Broken(_Source):
        def scan(self, idx):
            raise RuntimeError("disk on fire")

    runner = trun.SLAMRunner(trun.SLAMRunnerConfig(
        slam=_slam_cfg(tpipe), log_dir=str(tmp_path / "run")), device="cpu")
    out = runner.run({"bad": Broken(scans[:3], gt[:3]), "good": _Source(scans[:3], gt[:3])})
    assert "bad" not in out and "good" in out
    assert "disk on fire" in runner.failures["bad"]


def test_runner_writes_the_gallery(tmp_path, short_sequence, monkeypatch):
    """gallery=True: each sequence's gallery and player, as the reference's
    runner writes them, the player byte for byte the reference's on the same
    scans and poses; where matplotlib cannot be imported the gallery raises
    and the runner records the sequence as failed, as the reference's does."""
    import dataclasses
    import sys

    from pwclonet_pylidarslam_tpu.evaluation.player import write_run_player

    scans, gt = short_sequence
    cfg = trun.SLAMRunnerConfig(slam=_slam_cfg(tpipe), log_dir=str(tmp_path / "run"),
                                gallery=True, max_frames=4)
    runner = trun.SLAMRunner(cfg, device="cpu")
    assert "synth00" in runner.run({"synth00": _Source(scans, gt)}) and not runner.failures
    gal = tmp_path / "run" / "synth00_gallery"
    assert "frame 3" in (gal / "index.html").read_text()
    assert len(list(gal.glob("frame_*_vm.png"))) == len(list(gal.glob("frame_*_bev.png"))) == 4
    ref = write_run_player(str(tmp_path / "ref"), "synth00", [s[:, :3] for s in scans[:4]],
                           runner.pipelines["synth00"].absolute_poses(), gt[:4])
    assert (gal / "player.html").read_bytes() == Path(ref).read_bytes()

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runner = trun.SLAMRunner(dataclasses.replace(cfg, log_dir=str(tmp_path / "bare"),
                                                 max_frames=2), device="cpu")
    assert runner.run({"synth00": _Source(scans, gt)}) == {}
    assert "matplotlib" in runner.failures["synth00"]


def _lc_kw():
    return dict(submap_size=4, overlap=1, min_id_distance=50, points_per_frame=512,
                submap_points=1024)


def test_snapshot_restores_across_implementations(tmp_path, short_sequence):
    """A reference snapshot restores into the port (graph, loop-closure
    submaps, odometry state) and the next step agrees to 1e-5; a port
    snapshot restores into the reference; a port snapshot restored into the
    port continues bit for bit."""
    scans, _ = short_sequence
    kw = dict(with_backend=True, with_loop_closure=True, **SMALL_GRAPH)
    ref = jpipe.SLAM(_slam_cfg(jpipe, loop_closure=jlc.LoopClosureConfig(**_lc_kw()), **kw))
    ref.init()
    for s in scans[:6]:
        ref.process_next_frame(s)
    ref.snapshot(str(tmp_path / "ref"))
    cfg = _slam_cfg(tpipe, loop_closure=tlc.LoopClosureConfig(**_lc_kw()), **kw)
    port = _port_slam(cfg)
    port.restore(str(tmp_path / "ref"))
    assert len(port.builder.poses) == 6 and len(port.builder.edges) == 5
    assert len(port.loop_closure.submaps) == len(ref.loop_closure.submaps) == 1
    np.testing.assert_array_equal(port.loop_closure.submaps[0].points,
                                  np.asarray(ref.loop_closure.submaps[0].points))
    np.testing.assert_allclose(port.process_next_frame(scans[6]),
                               ref.process_next_frame(scans[6]), atol=1e-5)

    port.snapshot(str(tmp_path / "port"))
    back = jpipe.SLAM(_slam_cfg(jpipe, loop_closure=jlc.LoopClosureConfig(**_lc_kw()), **kw))
    back.restore(str(tmp_path / "port"))
    assert len(back.builder.poses) == 7 and len(back.builder.edges) == 6
    np.testing.assert_array_equal(np.stack(back.builder.poses), np.stack(port.builder.poses))
    np.testing.assert_array_equal(np.asarray(back.odometry.state.pose),
                                  port.odometry.state.pose.numpy())

    again = _port_slam(cfg)
    again.restore(str(tmp_path / "port"))
    for s in scans[7:9]:
        port.process_next_frame(s)
        again.process_next_frame(s)
    np.testing.assert_array_equal(port.absolute_poses(), again.absolute_poses())


def test_runner_resumes_from_snapshot(tmp_path, short_sequence):
    scans, gt = short_sequence
    log_dir = str(tmp_path / "run")
    base = dict(slam=_slam_cfg(tpipe), log_dir=log_dir, snapshot_every_frames=3)
    trun.SLAMRunner(trun.SLAMRunnerConfig(**base, max_frames=5), device="cpu").run(
        {"seq": _Source(scans, gt)})
    assert os.path.exists(os.path.join(log_dir, "seq.snapshot", "pipeline.npz"))
    runner = trun.SLAMRunner(trun.SLAMRunnerConfig(**base, resume=True), device="cpu")
    out = runner.run({"seq": _Source(scans, gt)})
    assert "seq" in out and not runner.failures
    # resumed at frame 3: only the 7 frames after the snapshot were stepped
    assert len(runner.pipelines["seq"].odometry.iterations) == 7
    assert runner.pipelines["seq"].absolute_poses().shape == (10, 4, 4)


def test_resync_moves_every_absolute_pose(short_sequence):
    scans, _ = short_sequence
    odo = ticp.ICPOdometry(ticp.ICPConfig(num_points=POINTS, map_stride=2), device="cpu")
    odo.init()
    odo.process_sequence(scans[:3])
    before = odo.state
    slam = _port_slam(tpipe.SLAMConfig(), odometry=odo)
    yaw = np.deg2rad(10.0)
    correction = np.array([[np.cos(yaw), -np.sin(yaw), 0, 3.0], [np.sin(yaw), np.cos(yaw), 0, -2.0],
                           [0, 0, 1, 0.5], [0, 0, 0, 1]])
    slam._resync_odometry(correction @ before.pose.numpy().astype(np.float64))
    c = torch.from_numpy(correction).float()
    after = odo.state
    np.testing.assert_allclose(after.pose, c @ before.pose, atol=1e-5)
    for name in ("last_kf_pose", "model_pose"):
        np.testing.assert_allclose(getattr(after, name), c @ getattr(before, name), atol=1e-5)
    np.testing.assert_allclose(after.map.poses, c[None] @ before.map.poses, atol=1e-5)
    assert torch.equal(after.map.points, before.map.points)  # the map moves with its poses


def test_gps_priors_enter_the_graph_and_optimize(tmp_path, short_sequence):
    scans, gt = short_sequence
    gps = np.full_like(gt, np.nan)
    gps[::4] = gt[::4]
    cfg = _slam_cfg(tpipe, with_backend=True, optimize_on_absolute=True, **SMALL_GRAPH)
    runner = trun.SLAMRunner(trun.SLAMRunnerConfig(
        slam=cfg, log_dir=str(tmp_path), use_gps=True), device="cpu")
    out = runner.run({"gps": _Source(scans[:6], gt[:6], gps[:6])})
    slam = runner.pipelines["gps"]
    assert "gps" in out and [p[0] for p in slam.builder.priors] == [0, 4]
    assert len(slam.optimizations) == 2
    assert all(o["stats"].gn_iterations >= 1 for o in slam.optimizations)
    with pytest.raises(ValueError, match="use_gps"):
        trun.SLAMRunner(trun.SLAMRunnerConfig(slam=_slam_cfg(tpipe), log_dir=str(tmp_path),
                                              use_gps=True, fail_on_error=True),
                        device="cpu").run({"gps": _Source(scans[:2], gt[:2], gps[:2])})


# the reference's largest final_on over its drift scenario's scans moved by
# -12..12 float32 ulp, on the CPU with its own projection (tests/drift_nudges.py)
DRIFT_REFERENCE_SPREAD = 0.9247  # m


@pytest.mark.slow
def test_loop_backend_reduces_drift():
    """The reference's drift scenario with three of the four gates of
    tests/test_pipeline.py::test_loop_backend_reduces_drift as it states
    them (~9 min here). The fourth, final_on < 0.5 m, is decided by the
    first ICP step, which no loop constraint observes and which lands short
    on many inputs: the reference's own final_on is 0.5 m or more on 11 of
    its scans moved by -12..12 float32 ulp, and the port's is 0.530 m on
    the unmoved scans. final_on is held to the reference's spread over
    those scans, and the error anchored at frame 1 to 0.5 m (ROADMAP
    Queue C)."""
    from pwclonet_pylidarslam_torch.slam import drift_injection as di

    slam_off, err_off = di.run_drift_scenario(with_backend=False, device="cpu")
    slam_on, err_on = di.run_drift_scenario(with_backend=True, device="cpu")
    assert len(slam_on.loop_closure.constraints) >= 1
    final_off, final_on = float(err_off[-10:].mean()), float(err_on[-10:].mean())
    anchored = di.anchored_errors(slam_on.absolute_poses(), di.scenario_ground_truth(), 1)
    assert final_on < 0.5 * final_off, (final_on, final_off)
    assert final_off > 1.0, final_off
    assert final_on <= DRIFT_REFERENCE_SPREAD, (final_on, float(err_on[1]))
    assert float(anchored[-10:].mean()) < 0.5, (anchored[-10:].mean(), final_on)


@pytest.mark.parametrize("source", ["port", "reference"])
def test_drift_first_step_from_one_state(tmp_path, source):
    """The drift scenario's first ICP step (identity prior, 1.6 m of
    motion), which decides its absolute error, from one frame-0 state: the
    port's step is the reference's, from either implementation's state. The
    two states differ (the scan's float32 projection rounds differently), so
    each implementation lands where it lands from its own."""
    from pwclonet_pylidarslam_torch.slam import drift_injection as tdi
    from pwclonet_pylidarslam_tpu.slam import drift_injection as jdi

    scans, gt = generate_sequence(SyntheticSequenceConfig(
        n_frames=80, trajectory="there_and_back", speed=1.6, seed=5, num_points=2048),
        device="cpu")
    cfg = dict(num_points=2048, initial_assoc_distance=8.0)

    def port():
        return tdi.DriftingICPOdometry(ticp.ICPConfig(**cfg), tdi.yaw_bias(), device="cpu")

    def ref():
        return jdi.DriftingICPOdometry(jicp.ICPConfig(**cfg), jdi.yaw_bias())

    first = port() if source == "port" else ref()
    first.init()
    first.process_next_frame(scans[0])
    path = str(tmp_path / "frame0.npz")
    first.snapshot(path)
    poses = []
    for make in (port, ref):
        odo = make()
        odo.init()
        odo.restore(path)
        poses.append(np.asarray(odo.process_next_frame(scans[1]), np.float64))
    np.testing.assert_allclose(poses[0], poses[1], atol=1e-4, rtol=0)
    assert abs(poses[0][0, 3] - gt[1, 0, 3]) < 1.6  # a step forward, short or not


def test_anchored_errors():
    from pwclonet_pylidarslam_torch.slam import drift_injection as di

    gt = di.scenario_ground_truth(10)
    assert gt.shape == (10, 4, 4) and gt[4, 0, 3] == pytest.approx(6.4)
    shifted = gt.copy()
    shifted[1:, 0, 3] -= 0.6  # a first step 0.6 m short, the rest exact
    np.testing.assert_allclose(di.anchored_errors(shifted, gt)[1:], 0.6)
    np.testing.assert_allclose(di.anchored_errors(shifted, gt, anchor=1)[1:], 0.0, atol=1e-12)
