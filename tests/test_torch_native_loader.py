"""The port's native scan loader (``data/native_loader.py``) against the
reference's, the cases of ``tests/test_native_loader.py`` on files written
under ``tmp_path`` from numpy seeds. Both compile the same
``native/scanio.cpp``; the port builds it into its own ``build/`` directory,
so its output is bit-equal to the reference's native output for the same
seed, and its ``backend="numpy"`` bit-equal to the reference's numpy
fallback. A failed build raises with the compiler's output (the reference
falls back to numpy instead)."""

import os

import numpy as np
import pytest

from pwclonet_pylidarslam_torch.data import native_loader as tnl
from pwclonet_pylidarslam_tpu.data import native_loader as jnl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bin_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bins")
    rng = np.random.default_rng(0)
    paths, clouds = [], []
    for i, n in enumerate([5000, 1200, 300]):
        pts = rng.normal(size=(n, 4)).astype(np.float32)
        p = str(d / f"{i:06d}.bin")
        pts.tofile(p)
        paths.append(p)
        clouds.append(pts)
    return paths, clouds


@pytest.fixture(scope="module")
def nclt_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nclt")
    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate([900, 40]):
        rec = rng.integers(0, 65535, size=(n, 4)).astype(np.uint16)
        rec[:, 3] = 0
        p = str(d / f"{1326030000000000 + i}.bin")
        rec.tofile(p)
        paths.append(p)
    return paths


def reference_numpy(fn, *args, **kw):
    """The reference's numpy fallback, forced as its own test forces it."""
    lib = jnl._lib
    try:
        jnl._lib, jnl._lib_error = None, "forced"
        return fn(*args, **kw)
    finally:
        jnl._lib, jnl._lib_error = lib, None


def test_the_library_is_built_in_the_ports_build_dir():
    shipped = os.path.join(REPO, "native", "libscanio.so")
    before = os.stat(shipped).st_mtime_ns
    assert tnl.native_available()
    path = tnl.library_path()
    assert path.exists() and path.parent == tnl.BUILD_DIR
    assert os.path.samefile(tnl.SOURCE, os.path.join(REPO, "native", "scanio.cpp"))
    assert os.stat(shipped).st_mtime_ns == before


def test_load_bins_counts_membership_and_the_reference(bin_files):
    paths, clouds = bin_files
    out, counts = tnl.load_bins_batch(paths, num_points=2048, channels=3, seed=7)
    ref, ref_counts = jnl.load_bins_batch(paths, num_points=2048, channels=3, seed=7)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(counts, [5000, 1200, 300])
    assert out.shape == (3, 2048, 3)
    for i, cloud in enumerate(clouds):  # every sampled point is an input point
        assert np.abs(out[i][:, None, :] - cloud[None, :, :3]).sum(-1).min(1).max() < 1e-6
    assert len(np.unique(out[0], axis=0)) == 2048  # subsample: no repeats
    assert len(np.unique(out[2], axis=0)) == 300  # pad: every point kept
    four, _ = tnl.load_bins_batch(paths, num_points=64, channels=4, seed=2, num_threads=2)
    np.testing.assert_array_equal(four, jnl.load_bins_batch(paths, 64, channels=4, seed=2)[0])


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_load_bins_bad_file(bin_files, tmp_path, backend):
    paths, _ = bin_files
    out, counts = tnl.load_bins_batch([paths[0], str(tmp_path / "missing.bin")],
                                      num_points=128, backend=backend)
    assert counts[1] == -1 and np.all(out[1] == 0) and counts[0] == 5000


def test_numpy_backend_is_the_references_fallback(bin_files, nclt_files):
    paths, _ = bin_files
    for channels in (3, 4):
        got = tnl.load_bins_batch(paths, num_points=256, channels=channels, seed=1,
                                  backend="numpy")
        want = reference_numpy(jnl.load_bins_batch, paths, num_points=256,
                               channels=channels, seed=1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = tnl.load_nclt_batch(nclt_files, num_points=100, seed=3, backend="numpy")
    for a, b in zip(got, reference_numpy(jnl.load_nclt_batch, nclt_files, 100, seed=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        tnl.load_bins_batch(paths, 16, backend="cuda")


def test_nclt_decode_and_the_reference(tmp_path, nclt_files):
    xyz = np.array([[1.0, 2.0, 3.0], [-5.0, 0.0, 10.0]], np.float32)
    packed = np.round((xyz + 100.0) / 0.005).astype(np.uint16)
    p = str(tmp_path / "scan.bin")
    np.concatenate([packed, np.zeros((2, 1), np.uint16)], -1).tofile(p)
    out, counts = tnl.load_nclt_batch([p], num_points=4)
    assert counts[0] == 2
    for row in out[0]:
        assert min(np.abs(row - xyz).sum(1)) < 0.01
    got = tnl.load_nclt_batch(nclt_files, num_points=512, seed=5)
    for a, b in zip(got, jnl.load_nclt_batch(nclt_files, num_points=512, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch, bin_files):
    bad = tmp_path / "scanio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "SOURCE", bad)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_error", None)
    with pytest.raises(RuntimeError, match="error") as info:
        tnl.load_bins_batch(bin_files[0], num_points=16)
    assert "scanio.cpp" in str(info.value)
    with pytest.raises(RuntimeError, match="unavailable"):  # kept: no retry, no fallback
        tnl.load_nclt_batch(bin_files[0], num_points=16)
    assert not tnl.native_available()
    assert not list((tmp_path / "build").glob("*.so"))


def test_prefetcher_overlap_and_errors():
    import time

    def slow_batches():
        for i in range(4):
            time.sleep(0.02)
            yield i

    assert list(tnl.Prefetcher(slow_batches, depth=2)) == [0, 1, 2, 3]

    def broken():
        yield 0
        raise RuntimeError("loader died")

    it = iter(tnl.Prefetcher(broken))
    assert next(it) == 0
    with pytest.raises(RuntimeError, match="loader died"):
        list(it)
