"""The slice as a whole: PWCLO-Net odometry of the port against the JAX
reference on one small synthetic corridor sequence, with the same converted
weights on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwclonet_pylidarslam_torch.models import PWCLONetConfig
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
from pwclonet_pylidarslam_tpu.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_tpu.models import PWCLONet as JPWCLONet
from pwclonet_pylidarslam_tpu.models import PWCLONetConfig as JPWCLONetConfig
from pwclonet_pylidarslam_tpu.slam import deep_odometry as jdo

SMALL = dict(num_points=256, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def sequence_and_reference():
    scans, _ = generate_sequence(SyntheticSequenceConfig(n_frames=6, num_points=256, seed=2))
    net = JPWCLONet(JPWCLONetConfig(**SMALL))
    x = jnp.asarray(scans[:1])
    keys = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
    vs = jax.jit(lambda a: net.init(keys, a, a, train=False))(x)
    vs = jax.tree.map(lambda a: np.asarray(a, np.float32), vs)
    rng = np.random.default_rng(3)
    # running statistics that make BatchNorm something other than identity
    stats = jax.tree.map(
        lambda a: (a + np.abs(rng.normal(size=a.shape)) * 0.3).astype(np.float32),
        vs["batch_stats"],
    )
    vs = {"params": vs["params"], "batch_stats": stats}
    ref = jdo.PWCLONetOdometry(
        vs, jdo.DeepOdometryConfig(model=JPWCLONetConfig(**SMALL), num_points=256)
    )
    ref.init()
    ref.process_sequence(scans)
    return scans, vs, ref.absolute_poses(), ref.relative_poses()


def _port(vs):
    odo = PWCLONetOdometry(
        vs, DeepOdometryConfig(model=PWCLONetConfig(**SMALL), num_points=256), device="cpu"
    )
    odo.init()
    return odo


def test_process_sequence_matches_reference(sequence_and_reference):
    scans, vs, ref_abs, ref_rel = sequence_and_reference
    odo = _port(vs)
    out = odo.process_sequence(scans)
    assert out.shape == (6, 4, 4) and out.dtype == np.float64
    np.testing.assert_allclose(odo.absolute_poses(), ref_abs, atol=POSE_ATOL)
    np.testing.assert_allclose(odo.relative_poses(), ref_rel, atol=POSE_ATOL)
    # the random weights must move the pose, or the check above is empty
    assert np.abs(ref_abs[-1] - np.eye(4)).max() > 1e-2


def test_per_frame_loop_matches_reference(sequence_and_reference):
    scans, vs, ref_abs, _ = sequence_and_reference
    odo = _port(vs)
    for scan in scans:
        pose = odo.process_next_frame(scan)
        assert pose.shape == (4, 4)
    np.testing.assert_allclose(odo.absolute_poses(), ref_abs, atol=POSE_ATOL)


def test_chunked_sequence_matches_reference(sequence_and_reference):
    scans, vs, ref_abs, _ = sequence_and_reference
    odo = _port(vs)
    odo.process_sequence(scans[:2])
    odo.process_sequence(scans[2:])
    np.testing.assert_allclose(odo.absolute_poses(), ref_abs, atol=POSE_ATOL)


def test_prepare_matches_reference(sequence_and_reference):
    scans, vs, _, _ = sequence_and_reference
    ref = jdo.PWCLONetOdometry(vs, jdo.DeepOdometryConfig(num_points=300))
    odo = PWCLONetOdometry(vs, DeepOdometryConfig(num_points=300,
                                                  model=PWCLONetConfig(**SMALL)), device="cpu")
    sparse = scans[0].copy()
    sparse[::2] = 0.0  # fewer points than requested: padded by resampling
    for scan in (scans[0], sparse):
        np.testing.assert_array_equal(odo._prepare([scan])[0].numpy(), ref._prepare(scan))


# chained pose entries (order 1) after five pairs: a few float32 ulps
GAP_TOL = 1e-5


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_per_frame_against_batched_gap_is_no_wider_than_the_references(
        sequence_and_reference, fused):
    """Pairs fed one at a time (``process_next_frame``) and in one batch
    (``process_sequence``) sum in other orders, so their poses differ by a
    little; the port's gap may not exceed the reference's, on the same scans
    and converted weights, by more than GAP_TOL."""
    scans, vs, _, _ = sequence_and_reference
    jcfg = jdo.DeepOdometryConfig(model=JPWCLONetConfig(**SMALL, fused_eval=fused), num_points=256)
    cfg = DeepOdometryConfig(model=PWCLONetConfig(**SMALL, fused_eval=fused), num_points=256)

    def gap(make):
        batched, per_frame = make(), make()
        batched.process_sequence(scans)
        for scan in scans:
            per_frame.process_next_frame(scan)
        return np.abs(batched.absolute_poses() - per_frame.absolute_poses()).max()

    def reference():
        odo = jdo.PWCLONetOdometry(vs, jcfg)
        odo.init()
        return odo

    def port():
        odo = PWCLONetOdometry(vs, cfg, device="cpu")
        odo.init()
        return odo

    ref_gap, port_gap = gap(reference), gap(port)
    assert port_gap <= ref_gap + GAP_TOL, (port_gap, ref_gap)
