"""The odometry's scan preparation (``ops/prepare.py`` through
``PWCLONetOdometry._prepare``) against the reference's numpy ``_prepare``,
bit for bit, on the CPU: synthetic sweeps, rows at the origin, scans under
``num_points`` (the padding draw), rows whose norms lie a few ulps either
side of the threshold in float32 and in float64 (each scan tested in its
own dtype, as the reference tests it), and the pairs a chunked sequence and
the frame-by-frame loop hand the network."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.models import PWCLONetConfig
from pwclonet_pylidarslam_torch.ops import prepare as tprepare
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
from pwclonet_pylidarslam_torch.utils import timer
from pwclonet_pylidarslam_tpu.slam import deep_odometry as jdo

SMALL = dict(num_points=128, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # six test workers: torch's per-worker pools would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference(scan: np.ndarray, n: int) -> np.ndarray:
    """The reference's ``_prepare`` of one scan (numpy; it reads only the
    configured point count)."""
    return jdo.PWCLONetOdometry._prepare(SimpleNamespace(config=SimpleNamespace(num_points=n)),
                                         scan)


def _odometry(n: int) -> PWCLONetOdometry:
    odo = PWCLONetOdometry(config=DeepOdometryConfig(model=PWCLONetConfig(**SMALL),
                                                     num_points=n), device="cpu")
    odo.init()
    return odo


@functools.lru_cache(maxsize=None)
def _sweeps() -> tuple:
    """Three sweeps of a small synthetic corridor, every hit kept (1,500-1,900
    of 2,880 rays), zero rows after the hits."""
    cfg = SyntheticSequenceConfig(n_frames=3, num_beams=16, num_cols=180, num_points=3000,
                                  seed=5)
    scans, _ = generate_sequence(cfg, device="cpu")
    return tuple(scans)


def _at_origin(rng) -> list:
    scans = [(rng.normal(size=(h, 3)) * 20).astype(np.float32) for h in (900, 1300, 700)]
    scans[0][::3] = 0.0
    scans[1][-200:] = 0.0
    scans[2][5] = (-0.0, 0.0, -0.0)
    return scans


def _under(rng) -> list:
    """Scans with fewer rows away from the origin than any ``n`` below: the
    draw with replacement fills them up."""
    scans = _at_origin(rng)
    scans[1][:1050] = 0.0  # 50 rows left
    scans.append((rng.normal(size=(1, 3)) * 5).astype(np.float32))  # one row
    return scans


def _near_threshold(rng) -> list:
    """Rows whose norms lie within a few float32 ulps of 1e-6, on both sides,
    with components of every relative size (so that the order of the sum
    decides some of them), among ordinary rows."""
    m = 40_000
    d = rng.normal(size=(m, 3)) * rng.choice([1.0, 1e-2, 1e-4], size=(m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ulps = rng.integers(-6, 7, size=(m, 1))
    rows = (d * (1e-6 * (1.0 + ulps * 2.0 ** -23))).astype(np.float32)
    norm = np.linalg.norm(rows, axis=-1)
    assert (norm > 1e-6).any() and (norm <= 1e-6).any()
    sq = rows.astype(np.float32) ** 2
    other_order = np.sqrt(sq[:, 0] + (sq[:, 1] + sq[:, 2])) > np.float32(1e-6)
    assert (other_order != (norm > 1e-6)).any()  # the order of the sum matters here
    far = (rng.normal(size=(m // 4, 3)) * 10).astype(np.float32)
    return [rows, np.concatenate([far, rows[: m // 2]]), rows[m // 2:]]


def _near_threshold_f64(rng) -> list:
    """Float64 rows whose norms lie within a few float64 ulps of 1e-6 and
    rows whose float32 and float64 tests disagree (the reference tests a
    scan in its own dtype), among float64 sweeps and ordinary rows."""
    m = 40_000
    d = rng.normal(size=(m, 3)) * rng.choice([1.0, 1e-2, 1e-4], size=(m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ulps = rng.integers(-6, 7, size=(m, 1))
    rows = np.concatenate([d * (1e-6 * (1.0 + ulps * 2.0 ** -52)),
                           d * (1e-6 * (1.0 + ulps * 2.0 ** -25))])
    norm = np.linalg.norm(rows, axis=-1)
    assert (norm > 1e-6).any() and (norm <= 1e-6).any()
    as_f32 = np.linalg.norm(rows.astype(np.float32), axis=-1) > 1e-6
    assert (as_f32 != (norm > 1e-6)).any()  # the dtype of the test matters here
    far = rng.normal(size=(m // 4, 3)) * 10
    return [rows[:m], np.concatenate([far, rows[m:]]),
            *(s.astype(np.float64) for s in _sweeps()[:2])]


CASES = {
    "synthetic sweeps": lambda rng: list(_sweeps()),
    "rows at the origin": _at_origin,
    "under num_points": _under,
    "near the threshold": _near_threshold,
    "float64 near the threshold": _near_threshold_f64,
}


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("case", list(CASES))
def test_prepare_equals_the_reference(case, n):
    scans = CASES[case](np.random.default_rng(11))
    got = _odometry(n)._prepare(scans)
    assert got.dtype == torch.float32 and got.shape == (len(scans), n, 3)
    np.testing.assert_array_equal(got.numpy(), np.stack([reference(s, n) for s in scans]))


@pytest.mark.parametrize("near", [_near_threshold, _near_threshold_f64])
def test_the_plain_test_is_numpys_norm(near):
    rows = np.concatenate(near(np.random.default_rng(3)))
    got = tprepare.away_from_origin(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, np.linalg.norm(rows, axis=-1) > 1e-6)


def test_scans_of_mixed_or_other_dtypes_raise():
    odo = _odometry(64)
    scan = np.ones((100, 3), np.float32)
    for scans in ([scan, scan.astype(np.float64)], [scan.astype(np.float16)]):
        with pytest.raises(TypeError, match="all float32 or all float64"):
            odo._prepare(scans)


@pytest.mark.parametrize("n,padded", [(64, 2), (1024, 4)])
def test_prepare_counts_its_scans(n, padded):
    scans = _under(np.random.default_rng(11))
    with timer.recording() as rec:
        _odometry(n)._prepare(scans)
    hits = sum(len(s) for s in scans)
    assert rec.counters == {
        "odometry.points_in": hits, "odometry.scans_padded": padded,
        "h2d.bytes": 12 * hits + 8 * (len(scans) + 1) + 4 * n * len(scans)}


def test_chunks_and_frames_hand_the_network_the_reference_pairs():
    """Ragged scans through ``process_sequence`` in two chunks (the previous
    chunk's last scan carried across) and through ``process_next_frame``: the
    pairs the network sees are the reference's prepared scans."""
    rng = np.random.default_rng(7)
    scans = _at_origin(rng) + _under(rng)[1:] + list(_sweeps())[:2]
    n = SMALL["num_points"]
    want = np.stack([reference(s, n) for s in scans])

    def pairs(run) -> tuple:
        odo = _odometry(n)
        seen = []
        real = odo._relative_poses

        def rel(cur, prev):
            seen.append((cur.numpy().copy(), prev.numpy().copy()))
            return real(cur, prev)

        odo._relative_poses = rel
        run(odo)
        return (np.concatenate([c for c, _ in seen]), np.concatenate([p for _, p in seen]),
                odo.absolute_poses())

    def chunked(odo):
        odo.process_sequence(scans[:3])
        odo.process_sequence(scans[3:])

    def frames(odo):
        for scan in scans:
            odo.process_next_frame(scan)

    for run in (chunked, frames):
        cur, prev, poses = pairs(run)
        np.testing.assert_array_equal(cur, want[1:])
        np.testing.assert_array_equal(prev, want[:-1])
        assert poses.shape == (len(scans), 4, 4)
