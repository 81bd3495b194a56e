"""Port parity: FPS, kNN and gather of ``pwclonet_pylidarslam_torch.ops``
against the JAX reference on the CPU. The CUDA kernels are held against
their plain versions in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.ops import fps as tfps
from pwclonet_pylidarslam_torch.ops import gather as tgather
from pwclonet_pylidarslam_torch.ops import prepare as tprepare
from pwclonet_pylidarslam_torch.ops.costvolume import _attentive_aggregate_cuda
from pwclonet_pylidarslam_torch.ops.knn import _knn_cuda, knn, knn_plain
from pwclonet_pylidarslam_torch.ops.mlp import _mlp_maxpool_cuda
from pwclonet_pylidarslam_tpu import ops as jops
from pwclonet_pylidarslam_tpu.ops.fps import _furthest_point_sample_lax


def _jax_fps(pts, npoint, mask=None):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(_furthest_point_sample_lax(jnp.asarray(pts), npoint, m))


class TestFPS:
    @pytest.mark.parametrize("b,n,npoint", [(2, 128, 16), (2, 500, 64), (1, 2048, 256)])
    def test_matches_reference(self, rng, b, n, npoint):
        pts = (rng.normal(size=(b, n, 3)) * 4.0).astype(np.float32)
        out = tfps.furthest_point_sample(torch.from_numpy(pts), npoint)
        assert out.dtype == torch.int32 and out.shape == (b, npoint)
        np.testing.assert_array_equal(out.numpy(), _jax_fps(pts, npoint))

    def test_padding_guard(self, rng):
        pts = (rng.normal(size=(2, 256, 3)) + 2.0).astype(np.float32)
        pts[:, :7] = 0.0  # sampling must start at the first valid point
        pts[0, 50:90] = 0.0
        out = tfps.furthest_point_sample(torch.from_numpy(pts), 64).numpy()
        np.testing.assert_array_equal(out, _jax_fps(pts, 64))
        assert out[0, 0] == 7 and not np.any((out[0] >= 50) & (out[0] < 90))
        assert not np.any(out < 7)

    def test_explicit_mask(self, rng):
        pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
        mask = np.zeros((2, 256), np.float32)
        mask[0, 128:] = 1
        mask[1, 10:20] = 1  # fewer valid points than npoint: picks repeat
        out = tfps.furthest_point_sample(torch.from_numpy(pts), 32, torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(out, _jax_fps(pts, 32, mask))
        assert np.all(out[0] >= 128) and np.all((out[1] >= 10) & (out[1] < 20))

    def test_non_multiple_of_128(self, rng):
        pts = (rng.normal(size=(1, 300, 3)) + 5.0).astype(np.float32)
        out = tfps.furthest_point_sample(torch.from_numpy(pts), 50).numpy()
        np.testing.assert_array_equal(out, _jax_fps(pts, 50))


class TestKNN:
    """Distances differ from the reference's by the rounding of the cross
    term: XLA's CPU dot chains fused multiply-adds, the port rounds each
    product (as its kernel does, built with --fmad=false). That is about one
    ulp of |q|^2 + |r|^2, so the inputs are unit-scale for atol 1e-5."""

    @pytest.mark.parametrize(
        "b,s,n,k",
        [(2, 64, 256, 8), (1, 128, 2048, 32), (2, 100, 300, 6), (1, 40, 40, 4), (2, 16, 5, 8)],
    )
    def test_matches_reference(self, rng, b, s, n, k):
        q = rng.normal(size=(b, s, 3)).astype(np.float32)
        r = rng.normal(size=(b, n, 3)).astype(np.float32)
        d, i = knn(torch.from_numpy(q), torch.from_numpy(r), k, approx=True)
        jd, ji = jops.knn(jnp.asarray(q), jnp.asarray(r), k, approx=True)
        assert i.dtype == torch.int32 and i.shape == (b, s, k) and d.shape == (b, s, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)

    def test_self_query_and_ties(self):
        # a grid has many exactly tied distances: ties go to the lower index,
        # as lax.top_k orders them (the reference's approx=True path on the
        # CPU, lax.approx_min_k, orders exact ties otherwise)
        g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
        pts = g.reshape(1, -1, 3).astype(np.float32)
        d, i = knn(torch.from_numpy(pts), torch.from_numpy(pts), 7)
        jd, ji = jops.knn(jnp.asarray(pts), jnp.asarray(pts), 7, approx=False)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(i.numpy()[0, :, 0], np.arange(pts.shape[1]))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)


def _knn_by_key(q, r, k):
    """The order the CUDA kernel keeps, modelled in numpy: every candidate is
    the 64-bit key ``(bits(d) << 32) | index`` of its float32 squared distance
    (each product and sum rounded on its own, clamped at 0), and the result is
    the ``k`` smallest keys in ascending order, whatever order they are met in."""
    q, r = q.astype(np.float32), r.astype(np.float32)

    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    cross = dot(q[:, :, None, :], r[:, None, :, :])
    d = np.maximum((dot(q, q)[:, :, None] + dot(r, r)[:, None, :]) - np.float32(2.0) * cross,
                   np.float32(0.0))
    assert d.dtype == np.float32
    keys = (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | np.arange(
        r.shape[1], dtype=np.uint64)
    # met in a scrambled order, as the lanes of a warp meet them
    order = np.random.default_rng(0).permutation(r.shape[1])
    best = np.sort(keys[..., order], axis=-1)[..., :k]
    return ((best >> np.uint64(32)).astype(np.uint32).view(np.float32),
            (best & np.uint64(0xFFFFFFFF)).astype(np.int32))


def _tie_heavy_case(name, rng):
    if name == "duplicated reference points":
        r = rng.normal(size=(2, 60, 3)).astype(np.float32)
        return rng.normal(size=(2, 33, 3)).astype(np.float32), np.concatenate([r, r, r], 1), 16
    if name == "integer grid":
        g = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1)
        pts = np.tile(g.reshape(1, -1, 3).astype(np.float32), (2, 1, 1))
        return pts[:, ::3], pts, 32
    if name == "k = N":
        return (rng.normal(size=(2, 40, 3)).astype(np.float32),
                rng.normal(size=(2, 27, 3)).astype(np.float32), 27)
    assert name == "coordinates at 50-80 m"
    # |q|^2 + |r|^2 - 2 q.r cancels ~1e4 down to ~1: distances come out on a
    # grid of 2^-10, many tie exactly, and some clamp to 0
    base = rng.uniform(50.0, 80.0, size=(1, 1, 3))
    r = (base + rng.normal(size=(2, 400, 3)) * 0.5).astype(np.float32)
    return (base + rng.normal(size=(2, 50, 3)) * 0.5).astype(np.float32), r, 32


@pytest.mark.parametrize("name", ["duplicated reference points", "integer grid", "k = N",
                                  "coordinates at 50-80 m"])
def test_knn_plain_keeps_the_key_order(rng, name):
    """What the kernel's 64-bit keys must reproduce: ``knn_plain`` (a stable
    sort of the same float32 distances) gives ascending distance, ties to the
    lower index, to the bit."""
    q, r, k = _tie_heavy_case(name, rng)
    d, i = knn_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    kd, ki = _knn_by_key(q, r, k)
    np.testing.assert_array_equal(i.numpy(), ki)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), kd.view(np.uint32))
    ties = int((np.diff(kd, axis=-1) == 0).sum())
    assert name == "k = N" or ties > 0, "the case must hold exact ties"
    assert np.all(np.diff(kd, axis=-1) >= 0)
    same = np.diff(kd, axis=-1) == 0
    assert np.all(np.diff(ki, axis=-1)[same] > 0)  # of equal distances the lower index first


class TestGather:
    def test_gather_points_bit_exact(self, rng):
        src = rng.normal(size=(2, 50, 19)).astype(np.float32)
        idx = rng.integers(0, 50, size=(2, 33)).astype(np.int32)
        out = tgather.gather_points(torch.from_numpy(src), torch.from_numpy(idx))
        ref = np.asarray(jops.gather_points(jnp.asarray(src), jnp.asarray(idx)))
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_group_points_bit_exact(self, rng):
        src = rng.normal(size=(2, 40, 3)).astype(np.float32)
        idx = rng.integers(0, 40, size=(2, 10, 8)).astype(np.int32)
        out = tgather.group_points(torch.from_numpy(src), torch.from_numpy(idx))
        ref = np.asarray(jops.group_points(jnp.asarray(src), jnp.asarray(idx)))
        assert out.shape == (2, 10, 8, 3)
        np.testing.assert_array_equal(out.numpy(), ref)

    @pytest.mark.parametrize("feat_dtype", [np.float32, np.float16])
    def test_group_points_multi_casts_back(self, rng, feat_dtype):
        xyz = rng.normal(size=(2, 40, 3)).astype(np.float32)
        feat = rng.normal(size=(2, 40, 16)).astype(feat_dtype)
        idx = rng.integers(0, 40, size=(2, 10, 6)).astype(np.int32)
        gx, gf = tgather.group_points_multi(torch.from_numpy(idx), torch.from_numpy(xyz),
                                            torch.from_numpy(feat))
        jx, jf = jops.group_points_multi(jnp.asarray(idx), jnp.asarray(xyz), jnp.asarray(feat))
        assert gx.dtype == torch.float32 and gf.numpy().dtype == feat_dtype
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(jf))
        # equal to grouping each tensor on its own
        np.testing.assert_array_equal(
            gf.numpy(), tgather.group_points(torch.from_numpy(feat), torch.from_numpy(idx)).numpy()
        )


def test_cpu_tensors_take_the_plain_path(rng):
    """On CPU tensors no kernel is launched: the counters do not move."""
    _cuda.reset_launch_counts()
    pts = torch.from_numpy(rng.normal(size=(1, 64, 3)).astype(np.float32))
    idx = tfps.furthest_point_sample(pts, 8)
    tgather.gather_points(pts, idx)
    knn(pts, pts, 4)
    x = torch.from_numpy(rng.normal(size=(1, 8, 4, 3)).astype(np.float32))
    one = ((torch.ones(3, 3),), (torch.zeros(3),))
    ops.mlp_maxpool(x, one)
    enc = ((torch.ones(10, 3),), (torch.zeros(3),))
    att = ((torch.ones(9, 3),), (torch.zeros(3),))
    ops.attentive_aggregate(pts[:, :8], x, pts[:, :8], x, enc, None, att, True)
    tgather.scatter_add_rows(pts[:, :8], idx, 64)
    src = pts.clone().requires_grad_()
    tgather.gather_points(src, idx).sum().backward()  # the plain path's own autograd
    offsets = torch.tensor([0, 40, 64])
    keep, _ = tprepare.keep_rows(pts[0], offsets)
    tprepare.take_rows(pts[0], offsets, keep, torch.zeros(2, 8, dtype=torch.int32))
    assert _cuda.launch_counts() == {
        "fps": 0, "knn": 0, "gather": 0, "scatter_add": 0, "mlp_maxpool": 0,
        "attentive_aggregate": 0, "prepare_keep": 0, "prepare_take": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points take only CUDA tensors; they never fall back."""
    pts = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tfps._furthest_point_sample_cuda(pts, 4, None)
    with pytest.raises(ValueError, match="CUDA"):
        _knn_cuda(pts, pts, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tgather._gather_points_cuda(pts, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tgather._scatter_add_rows_cuda(pts, torch.zeros(1, 8, dtype=torch.int32), 4)
    x = torch.zeros(1, 8, 4, 3)
    one = ((torch.ones(3, 3),), (torch.zeros(3),))
    with pytest.raises(ValueError, match="CUDA"):
        _mlp_maxpool_cuda(x, one)
    with pytest.raises(ValueError, match="CUDA"):
        _attentive_aggregate_cuda(pts, x, pts, x, ((torch.ones(10, 3),), (torch.zeros(3),)),
                                  None, ((torch.ones(9, 3),), (torch.zeros(3),)), True)
    offsets = torch.tensor([0, 8])
    with pytest.raises(ValueError, match="CUDA"):
        tprepare._keep_rows_cuda(pts[0], offsets)
    with pytest.raises(ValueError, match="CUDA"):
        tprepare._take_rows_cuda(pts[0], offsets, torch.zeros(8, dtype=torch.int32),
                                 torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4, 3))


@pytest.mark.parametrize("b,n,m,tile,ints", [
    # the train step's level-2 grouping: 16 tiles of 2048 entries a sample
    (16, 2048, 32768, 2048, 2 * 16 * 32768 + 16 * 16 * 2048),
    (8, 1024, 16384, 1024, 2 * 8 * 16384 + 8 * 16 * 1024),
    # the train step's other shapes
    (8, 2048, 12288, 2048, 2 * 8 * 12288 + 8 * 6 * 2048),
    (8, 2048, 8192, 2048, 2 * 8 * 8192 + 8 * 4 * 2048),
    (8, 1024, 6144, 1024, 2 * 8 * 6144 + 8 * 6 * 1024),
    (16, 1024, 4096, 1024, 2 * 16 * 4096 + 16 * 4 * 1024),
    (8, 256, 1536, 256, 2 * 8 * 1536 + 8 * 6 * 256),
    (8, 64, 2048, 256, 2 * 8 * 2048 + 8 * 8 * 64),  # tiles of at least 256 entries
    (3, 5000, 20001, 8192, 2 * 3 * 20001 + 3 * 3 * 5000),  # N no power of two
    (1, 1, 7, 256, 2 * 7 + 1),
    (2, 10, 0, 256, 2 * 10),  # no updates: one tile's row starts alone
])
def test_scatter_add_scratch(b, n, m, tile, ints):
    """Tiles of a power of two >= max(256, N) entries; scratch of a rank and a
    member an entry, and a first slot for each row in each tile, which comes
    to at most M + tile ints a sample; beside it, room to list the rows of
    more than ``LONG_ROW`` updates: a sample has at most M // (LONG_ROW + 1)."""
    longs = b * (m // (tgather.LONG_ROW + 1))
    assert tgather.scatter_plan_sizes(b, n, m) == (tile, ints, longs)
    assert ints - 2 * b * m <= b * (m + tile)
