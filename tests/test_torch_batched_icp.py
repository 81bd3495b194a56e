"""Batched multi-sequence ICP odometry (``BatchedICPOdometry``,
``process_frame_batched``) and the timer, profiler and check helpers of the
port on the CPU, against the JAX reference and against the port's own
single-sequence path.

Tolerances, and why:
- against the reference's ``BatchedICPOdometry``: each sequence's chain to
  ``max(1e-3, 3 x sens)`` in translation (m) and rotation (matrix entries),
  where ``sens`` is the reference's batched chain's own movement when its
  scans move by one float32 ulp, as ``tests/test_torch_icp.py`` holds the
  single path;
- against the port's ``ICPOdometry`` (the cache off, as the batched mode
  forces it): bit-equal on the CPU. The step has one code path for S = 1 and
  S > 1; every product of it rounds a sequence's row as it rounds it alone
  (the gradient is taken as ``rᵀJ``, ``core/optimization.py``). The
  Gauss-Newton iterations of every sequence, the one that stops first
  included, equal the single path's, and the host reads of a step are
  those of its slowest sequence: they do not grow with S.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist

from pwclonet_pylidarslam_torch import parallel as tpar
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.slam import BatchedICPOdometry
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.utils import checks as tchecks, timer as ttimer
from pwclonet_pylidarslam_tpu.slam import icp_odometry as jicp
from pwclonet_pylidarslam_tpu.utils import checks as jchecks

MODES = {"projective": 6, "voxel": 4}  # association -> frames
# the port's single path: the two associations, and the BEV bootstrap's
# batched registration (its FFTs over the sequence axis)
SINGLE_PATH_CASES = {"projective": ({}, 6), "voxel": ({"association": "voxel"}, 4),
                     "bev_bootstrap": ({"bev_bootstrap": True}, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread: with several test workers on one
    machine, torch's thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_sequences():
    """The inputs of ``tests/test_icp_odometry.py::test_batched_matches_single_sequence``:
    seeds 0 and 1, 6 frames, 2048 points, ``speed=0.8``; ``(2, 6, N, 3)``."""
    return np.stack([
        generate_sequence(SyntheticSequenceConfig(n_frames=6, num_points=2048, seed=seed,
                                                  speed=0.8), device="cpu")[0]
        for seed in (0, 1)])


def _ref_chains(kw, batch):
    odo = jicp.BatchedICPOdometry(jicp.ICPConfig(**kw))
    odo.init(n_sequences=batch.shape[0])
    return odo.process_chunk(batch)


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_matches_reference(two_sequences, mode):
    batch = two_sequences[:, :MODES[mode]]
    kw = dict(num_points=2048, association=mode)
    ref = _ref_chains(kw, batch)
    sens = np.zeros(batch.shape[0])
    for direction in (np.inf, -np.inf):
        nudged = np.where(batch != 0, np.nextafter(batch, np.float32(direction)), 0.0)
        moved = _ref_chains(kw, nudged.astype(np.float32))
        sens = np.maximum(sens, np.abs(moved[..., :3, 3] - ref[..., :3, 3]).max(axis=(1, 2)))
    odo = BatchedICPOdometry(ticp.ICPConfig(**kw), device="cpu")
    odo.init(n_sequences=batch.shape[0])
    got = odo.process_chunk(batch)
    assert got.shape == ref.shape == batch.shape[:2] + (4, 4)
    np.testing.assert_array_equal(odo.absolute_poses(), got)
    for s in range(batch.shape[0]):
        bar = max(1e-3, 3.0 * sens[s])
        gap = np.abs(got[s, :, :3, 3] - ref[s, :, :3, 3]).max()
        assert gap <= bar, (s, gap, sens[s])
        assert np.abs(got[s, :, :3, :3] - ref[s, :, :3, :3]).max() <= bar


@pytest.mark.parametrize("case", list(SINGLE_PATH_CASES))
def test_batched_equals_the_single_path(two_sequences, case):
    """S = 3: the two sequences and a stationary one (its first scan
    repeated), which converges and freezes first."""
    kw, t = SINGLE_PATH_CASES[case]
    still = np.repeat(two_sequences[0, :1], t, axis=0)[None]
    batch = np.concatenate([two_sequences[:, :t], still])
    odo = BatchedICPOdometry(ticp.ICPConfig(num_points=2048, **kw), device="cpu")
    odo.init(n_sequences=3)
    got = odo.process_chunk(batch[:, :2])
    got = np.concatenate([got, odo.process_chunk(batch[:, 2:])], axis=1)  # two chunks
    singles = []
    for s in range(3):
        single = ticp.ICPOdometry(odo.config, device="cpu")
        single.init()
        single.process_sequence(batch[s, :2])
        single.process_sequence(batch[s, 2:])
        singles.append(single)
        poses = single.absolute_poses()
        assert np.abs(got[s, 1] - poses[1]).max() <= 1e-6  # the first step
        np.testing.assert_array_equal(got[s], poses)
    for f in range(t):
        assert odo.iterations[f] == [single.iterations[f] for single in singles], f
        assert odo.host_reads[f] == max(single.host_reads[f] for single in singles), f
    # the stationary sequence stops first on every frame that registers
    assert all(odo.iterations[f][2] < max(odo.iterations[f][:2]) for f in range(1, t))


def test_equal_sequences_give_equal_trajectories(two_sequences):
    batch = np.stack([two_sequences[1, :4]] * 2)
    odo = BatchedICPOdometry(ticp.ICPConfig(num_points=2048), device="cpu")
    odo.init(n_sequences=2)
    poses = odo.process_chunk(batch)
    np.testing.assert_array_equal(poses[0], poses[1])
    assert odo.iterations[-1][0] == odo.iterations[-1][1]


def test_host_reads_do_not_grow_with_the_batch(two_sequences):
    """One sequence alone and three copies of it in one batch: the same
    iterations and the same host reads a step."""
    batch = two_sequences[1:, :4]
    reads = {}
    for s in (1, 3):
        odo = BatchedICPOdometry(ticp.ICPConfig(num_points=2048), device="cpu")
        odo.init(n_sequences=s)
        odo.process_chunk(np.repeat(batch, s, axis=0))
        reads[s] = (odo.host_reads, [it[0] for it in odo.iterations])
    assert reads[1] == reads[3] and sum(reads[1][0]) > 4


def test_config_and_refusals():
    voxel = ticp.ICPConfig(num_points=256, association="voxel")
    assert voxel.voxel_candidate_cache
    odo = BatchedICPOdometry(voxel, device="cpu")
    assert not odo.config.voxel_candidate_cache
    assert BatchedICPOdometry(ticp.ICPConfig(num_points=256), device="cpu").config == \
        ticp.ICPConfig(num_points=256)
    # the sequence axis split over a mesh: a data axis of two ranks refuses
    # an S that does not divide (before any collective), and one rank's mesh
    # takes every S
    class TwoRanks:
        def __getitem__(self, axis):
            return SimpleNamespace(get_group=lambda: None, get_local_rank=lambda: 0,
                                   size=lambda: 2)

    with pytest.raises(ValueError, match="divisible"):
        BatchedICPOdometry(voxel, device="cpu", mesh=TwoRanks()).init(3)
    started = not dist.is_initialized()
    try:
        odo = BatchedICPOdometry(voxel, device="cpu", mesh=tpar.make_mesh(device="cpu"))
        odo.init(3)
        assert odo.states.pose.shape[0] == 3
    finally:
        if started:
            tpar.shutdown()
    state = ticp.init_states(voxel, 2, device="cpu")
    with pytest.raises(ValueError, match="one sequence"):
        ticp.process_frame_batched(voxel, state, torch.zeros(2, 256, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchedICPOdometry(voxel)


# --- the timer, the profiler hook and the checks --------------------------------


def test_timers_and_timed_call():
    timers = ttimer.Timers()
    out = []
    for _ in range(3):
        with timers.time("matmul", result=out):
            out.append(torch.ones(64, 64) @ torch.ones(64, 64))
    summary = timers.summary()
    assert list(summary) == ["matmul"] and summary["matmul"] > 0
    assert timers.durations["matmul"].count == 3
    assert ttimer.Duration().average == 0.0
    seconds, result = ttimer.timed_call(torch.add, torch.ones(3), torch.ones(3), n=4, warmup=2)
    assert seconds > 0 and torch.equal(result, torch.full((3,), 2.0))


def test_profiler_trace_writes_a_trace(tmp_path):
    import json

    with ttimer.profiler_trace(str(tmp_path / "prof"), device="cpu") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof is not None
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with ttimer.profiler_trace(str(tmp_path / "card")):
                pass


@pytest.mark.parametrize("shape,expected", [
    ((2, 3, 4), (2, -1, 4)), ((2, 3, 4), (2, 3, 5)), ((2, 3), (2, 3, 1)), ((5,), (-1,)),
])
def test_checks_match_reference(shape, expected):
    x = np.zeros(shape, np.float32)

    def outcome(fn, arr):
        try:
            fn(arr, expected, name="pts")
            return None
        except AssertionError as e:
            return str(e)

    assert outcome(tchecks.check_tensor, torch.from_numpy(x)) == outcome(
        jchecks.check_tensor, jnp.asarray(x))
    for fn in (tchecks.assert_debug, jchecks.assert_debug):
        fn(True, "never")
        for message, said in (("bad", "bad"), ("", "assert_debug failed")):
            with pytest.raises(AssertionError, match=said):
                fn(False, message)
    pts = np.array([[1.0, 2.0, 3.0], [np.nan, 0.0, 0.0], [4.0, np.inf, 1.0], [5.0, 6.0, 7.0]],
                   np.float32)
    np.testing.assert_array_equal(tchecks.remove_nan(pts), jchecks.remove_nan(pts))
    for fill in (0.0, -1.5):
        np.testing.assert_array_equal(
            tchecks.scrub_nonfinite(torch.from_numpy(pts), fill).numpy(),
            np.asarray(jchecks.scrub_nonfinite(jnp.asarray(pts), fill)))
