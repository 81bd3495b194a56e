"""On the card: each CUDA kernel of ``pwclonet_pylidarslam_torch`` against
its plain PyTorch version, at the shapes of the full-width main path.

Skipped where ``torch.cuda.is_available()`` is false. Imports nothing of
JAX, so it runs on a GPU machine without it:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.ops import fps as tfps
from pwclonet_pylidarslam_torch.ops import gather as tgather
from pwclonet_pylidarslam_torch.ops.costvolume import attentive_aggregate_plain
from pwclonet_pylidarslam_torch.ops.knn import _knn_cuda, knn, knn_plain
from pwclonet_pylidarslam_torch.ops.mlp import mlp_maxpool_plain


def _rand(rng, device, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# main-path sizes (one block a sample up to 4096 points, a cluster above),
# sizes that fill no warp or thread evenly, the largest the kernel takes
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,npoint", [
    (2, 8192, 2048), (2, 2048, 1024), (2, 1024, 256), (2, 256, 64), (2, 300, 50), (1, 1, 3),
    (3, 4097, 300), (2, 5000, 700), (1, 16384, 512), (2, 12345, 200), (18, 8192, 256),
    (18, 2048, 256),
])
def test_fps_kernel_matches_plain(cuda_device, rng, b, n, npoint):
    pts = torch.from_numpy((rng.normal(size=(b, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    pts[0, :5] = 0.0
    out = tfps.furthest_point_sample(pts, npoint)
    ref = tfps.furthest_point_sample_plain(pts, npoint)
    assert out.dtype == torch.int32 and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("case", ["mask", "fewer valid than npoint", "none valid", "duplicated"])
def test_fps_kernel_masks_and_ties(cuda_device, rng, n, case):
    pts = torch.from_numpy((rng.normal(size=(2, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    mask = None
    if case == "mask":
        mask = torch.from_numpy((rng.random(size=(2, n)) > 0.4).astype(np.float32)).to(cuda_device)
        mask[:, :9] = 0.0
    elif case == "fewer valid than npoint":
        mask = torch.zeros(2, n, device=cuda_device)
        mask[0, 100:140] = 1.0
        mask[1, n - 7:] = 1.0
    elif case == "none valid":
        pts[0] = 0.0  # the padding guard rejects every point of sample 0
        mask = None
    else:
        pts = torch.cat([pts[:, : n // 2], pts[:, : n // 2]], dim=1)  # every point twice: ties
    out = tfps.furthest_point_sample(pts, 128, mask)
    ref = tfps.furthest_point_sample_plain(pts, 128, mask)
    assert torch.equal(out, ref)
    if case == "none valid":
        assert int(out[0].max()) == 0


@pytest.mark.cuda
def test_fps_kernel_variants_and_skeleton(cuda_device, rng):
    """Every cluster size gives the kernel's own picks; the skeleton (no
    distance update) repeats the first pick; a cluster size or thread count
    the kernel does not take raises, as does a cloud above its size."""
    pts = torch.from_numpy((rng.normal(size=(2, 8192, 3)) * 10).astype(np.float32)).to(cuda_device)
    ref = tfps.furthest_point_sample_plain(pts, 200)
    for cluster in (1, 2, 4, 8):
        out = tfps._furthest_point_sample_cuda(pts, 200, None, cluster=cluster, threads=1024)
        assert torch.equal(out, ref), cluster
    skel = tfps._furthest_point_sample_cuda(pts, 50, None, skeleton=True)
    assert torch.equal(skel, ref[:, :1].expand(-1, 50))
    with pytest.raises(RuntimeError):
        tfps._furthest_point_sample_cuda(pts, 8, None, cluster=3)
    with pytest.raises(RuntimeError):
        tfps._furthest_point_sample_cuda(pts, 8, None, threads=256)  # 32 points a thread
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(torch.zeros(1, 16385, 3, device=cuda_device), 8)
    torch.cuda.synchronize()


def _knn_equal(q, r, k):
    d, i = knn(q, r, k)
    pd, pi = knn_plain(q, r, k)
    torch.cuda.synchronize()
    # both round every product and sum on its own: equal to the bit
    assert torch.equal(i, pi), f"{int((i != pi).sum())} indices differ"
    assert torch.equal(d, pd)


# main-path shapes, S and N that are no multiple of the tile (2048), of the
# votes' stride (128) or of the queries per block (4, 8), k = N, a large batch
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n,k", [
    (2, 2048, 8192, 32), (2, 2048, 2048, 6), (2, 256, 64, 8), (2, 64, 10, 4), (1, 1, 1, 1),
    (2, 1027, 2049, 32), (3, 13, 4100, 16), (2, 333, 127, 1), (2, 77, 129, 8), (1, 5, 32, 32),
    (2, 50, 31, 31), (2, 9, 6, 6), (18, 1024, 2048, 32), (18, 100, 300, 4),
])
def test_knn_kernel_matches_plain(cuda_device, rng, b, s, n, k):
    q = torch.from_numpy((rng.normal(size=(b, s, 3)) * 10).astype(np.float32)).to(cuda_device)
    r = torch.from_numpy((rng.normal(size=(b, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    _knn_equal(q, r, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 6, 8, 16, 32])
@pytest.mark.parametrize("case", ["integer grid", "duplicated points", "far from the origin"])
def test_knn_kernel_orders_ties_as_plain(cuda_device, rng, case, k):
    if case == "integer grid":
        g = torch.stack(torch.meshgrid(*[torch.arange(11.0)] * 3, indexing="ij"), -1)
        r = g.reshape(1, -1, 3).repeat(2, 1, 1).to(cuda_device)
        q = r[:, ::5].contiguous()
    elif case == "duplicated points":
        base = _rand(rng, cuda_device, 2, 700, 3, scale=5.0)
        r = torch.cat([base, base, base[:, :100]], dim=1)
        q = base[:, :300].contiguous()
    else:
        # at 50-80 m the formula cancels to a grid of 2^-10: exact ties, clamped zeros
        centre = torch.tensor([60.0, 75.0, 52.0], device=cuda_device)
        r = centre + _rand(rng, cuda_device, 2, 3000, 3, scale=0.5)
        q = centre + _rand(rng, cuda_device, 2, 500, 3, scale=0.5)
    _knn_equal(q, r, k)
    for warps in (1, 3, 8):  # any number of queries a block gives the same
        d, i = _knn_cuda(q, r, k, warps=warps)
        assert torch.equal(i, knn_plain(q, r, k)[1]), warps


@pytest.mark.cuda
def test_knn_kernel_refuses_what_it_cannot_take(cuda_device):
    pts = torch.rand(1, 64, 3, device=cuda_device)
    with pytest.raises(ValueError):
        _knn_cuda(pts, pts, 33)
    with pytest.raises(ValueError):
        _knn_cuda(pts, pts[:, :5].contiguous(), 8)  # k above N: knn() pads, the kernel refuses
    with pytest.raises(RuntimeError):
        _knn_cuda(pts, pts, 4, warps=9)
    d, i = knn(pts, pts[:, :5].contiguous(), 8)  # padded by repeating the nearest hit
    assert torch.equal(i[..., 5:], i[..., :1].expand(-1, -1, 3))


# the path's widths at its widest calls, widths of one to 2101 floats, M no
# multiple of 32 or of a tile, M = 0, B = 16
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,c", [
    (2, 8192, 65536, 3), (2, 8192, 65536, 19), (2, 8192, 65536, 35), (2, 8192, 65536, 67),
    (16, 2048, 32768, 19), (8, 1024, 16384, 67), (16, 8192, 65536, 3), (3, 100, 1001, 1),
    (2, 50, 77, 2), (1, 300, 333, 4), (5, 64, 31, 5), (16, 40, 257, 131), (2, 10, 0, 3),
    (1, 1, 1, 1), (4, 7, 5000, 2101),
])
def test_gather_kernel_matches_plain(cuda_device, rng, b, n, m, c):
    src = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, n, size=(b, m)).astype(np.int32)).to(cuda_device)
    out = tgather.gather_points(src, idx)
    assert out.shape == (b, m, c) and torch.equal(out, tgather.gather_points_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 4, 67])
def test_gather_kernel_unaligned_source(cuda_device, rng, c):
    """A contiguous source with a storage offset is not 16-byte aligned: the
    kernel copies its rows all the same."""
    b, n, m = 3, 500, 4099
    flat = torch.from_numpy(rng.normal(size=b * n * c + 1).astype(np.float32)).to(cuda_device)
    shifted = flat[1:].view(b, n, c)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    idx = torch.from_numpy(rng.integers(0, n, size=(b, m)).astype(np.int32)).to(cuda_device)
    assert torch.equal(tgather.gather_points(shifted, idx), tgather.gather_points_plain(shifted, idx))


def _scatter_add_exact(upd, idx, n):
    out = tgather.scatter_add_rows(upd, idx, n)
    again = tgather.scatter_add_rows(upd, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no float atomics: the order of the adds is fixed
    # the order the kernel promises is a sequential loop over m: index_add_ on the CPU
    loop = tgather.scatter_add_rows_plain(upd.cpu(), idx.cpu(), n)
    assert torch.equal(out.cpu(), loop), f"{int((out.cpu() != loop).sum())} elements differ"
    # the plain version on the card adds with atomics in another order: atol
    # 1e-5 of the largest sum of magnitudes
    scale = max(1.0, tgather.scatter_add_rows_plain(upd.abs(), idx, n).max().item())
    torch.testing.assert_close(out, tgather.scatter_add_rows_plain(upd, idx, n),
                               atol=1e-5 * scale, rtol=0)


# full-width backward shapes at batch 8, N = 8192 at B = 16 (more rows than one
# pass of shared-memory counters), then M no multiple of 128 or of a tile, a
# heavily repeated index (three rows take every update), rows that take none
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,c,targets", [
    (8, 2048, 32768, 19, None), (8, 1024, 16384, 67, None), (8, 256, 1024, 131, None),
    (2, 100, 333, 5, None), (2, 64, 5000, 7, 3), (1, 4096, 50, 33, None),
    (16, 2048, 32768, 19, None), (16, 8192, 32768, 1, None), (16, 8192, 32768, 19, None),
    (16, 8192, 16384, 67, None), (16, 8192, 8192, 131, None), (3, 5000, 20001, 3, None),
    (2, 10, 0, 4, None), (1, 1, 7, 1, None),
])
def test_scatter_add_kernel_matches_plain_and_itself(cuda_device, rng, b, n, m, c, targets):
    upd = _rand(rng, cuda_device, b, m, c)
    high = n if targets is None else targets
    idx = torch.from_numpy(rng.integers(0, high, size=(b, m)).astype(np.int32)).to(cuda_device)
    _scatter_add_exact(upd, idx, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["32 each", "33 each", "one row takes 4096", "odd rows take none"])
def test_scatter_add_kernel_segment_lengths(cuda_device, rng, case):
    """Segments of exactly one and just over one warp's width, one long
    segment among short ones, and rows that take no update (written 0)."""
    b, n, c = 2, 700, 19
    if case in ("32 each", "33 each"):
        per = int(case.split()[0])
        idx = np.stack([rng.permutation(np.repeat(np.arange(n), per)) for _ in range(b)])
    elif case == "one row takes 4096":
        idx = rng.integers(0, n, size=(b, 9000))
        for row in idx:
            row[rng.choice(9000, 4096, replace=False)] = 7
    else:
        idx = 2 * rng.integers(0, n // 2, size=(b, 5000))
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    _scatter_add_exact(_rand(rng, cuda_device, b, idx.shape[1], c), idx, n)


@pytest.mark.cuda
def test_gather_gradient_is_the_scatter_add_kernel(cuda_device, rng):
    src = _rand(rng, cuda_device, 2, 512, 35).requires_grad_()
    other = _rand(rng, cuda_device, 2, 512, 3).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 512, size=(2, 300, 8)).astype(np.int32)).to(cuda_device)
    _cuda.reset_launch_counts()
    a, b = tgather.group_points_multi(idx, src, other)  # one gather, slices of its output
    loss = (a ** 2).sum() + (b[..., :2] * 3.0).sum()
    loss.backward()
    assert _cuda.launch_counts()["gather"] == 1 and _cuda.launch_counts()["scatter_add"] == 1
    assert idx.grad is None
    cpu_src = src.detach().cpu().requires_grad_()
    cpu_other = other.detach().cpu().requires_grad_()
    ca, cb = tgather.group_points_multi(idx.cpu(), cpu_src, cpu_other)  # the plain path's autograd
    ((ca ** 2).sum() + (cb[..., :2] * 3.0).sum()).backward()
    torch.testing.assert_close(src.grad.cpu(), cpu_src.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(other.grad.cpu(), cpu_other.grad, atol=1e-4, rtol=1e-5)
    # a source that does not require grad launches no scatter-add
    tgather.gather_points(src.detach(), idx[:, :, 0].contiguous())
    assert _cuda.launch_counts()["scatter_add"] == 1


def _stack(rng, cin, widths, device):
    """Random folded ``(weights, biases)`` of a stack on ``device``."""
    ws, bs = [], []
    for cout in widths:
        ws.append(torch.from_numpy(
            (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)).to(device))
        bs.append(torch.from_numpy((rng.normal(size=cout) * 0.3).astype(np.float32)).to(device))
        cin = cout
    return tuple(ws), tuple(bs)


@pytest.fixture
def full_fp32():
    """The plain versions' matmuls in full float32, as the kernels compute."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


# main-path shapes, then odd ones: K not a power of two, widths that are no
# multiple of 8, a last tile of fewer centres, one layer; then centres that
# span tiles (K = 100 and 200 at width 128: 64-row tiles; K = 4096: 32 tiles
# of 128 rows), a ragged last tile, a single centre, B = 9 at small S, one
# layer 128 wide
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,k,cin,widths", [
    (1, 2048, 32, 6, (8, 8, 16)), (1, 1024, 32, 19, (16, 16, 32)), (1, 256, 16, 35, (32, 32, 64)),
    (1, 64, 16, 67, (64, 64, 128)), (1, 64, 16, 67, (128, 64, 64)), (1, 2048, 8, 67, (128, 64)),
    (9, 1024, 8, 67, (128, 64)), (2, 333, 6, 11, (16, 9, 33)), (3, 7, 5, 3, (5,)),
    (1, 5, 100, 20, (40, 24)),
    (1, 5, 100, 67, (128, 64)), (2, 3, 200, 19, (16, 128)), (1, 2, 4096, 6, (8,)),
    (1, 1023, 8, 67, (128, 64)), (1, 2047, 32, 6, (8, 8, 16)), (1, 1, 16, 67, (64, 64, 128)),
    (1, 1, 32, 6, (8, 8, 16)), (9, 37, 16, 35, (32, 32, 64)), (2, 100, 16, 67, (128,)),
])
def test_mlp_maxpool_kernel_matches_plain(cuda_device, full_fp32, rng, b, s, k, cin, widths):
    x = _rand(rng, cuda_device, b, s, k, cin)
    wb = _stack(rng, cin, widths, cuda_device)
    out = ops.mlp_maxpool(x, wb)
    torch.cuda.synchronize()
    # 3xTF32 products (about 22 bits of each operand) summed in another
    # order than the library's fp32 matmul
    torch.testing.assert_close(out, mlp_maxpool_plain(x, wb), atol=3e-5, rtol=1e-4)
    # a stack folded by fold_stack (PointMLP.folded()) keeps its fragment
    # layout: a second call reuses it, same result
    from pwclonet_pylidarslam_torch.ops.mlp import fold_stack
    ones = [torch.ones(w.shape[1], device=cuda_device) for w in wb[0]]
    zeros = [torch.zeros_like(o) for o in ones]
    layers = [(w, o, bias, z, o - 1e-5) for w, bias, o, z in zip(*wb, ones, zeros)]
    folded = fold_stack(layers)
    torch.testing.assert_close(ops.mlp_maxpool(x, folded), out, atol=1e-6, rtol=1e-6)
    assert torch.equal(ops.mlp_maxpool(x, folded), ops.mlp_maxpool(x, folded))
    assert len(folded.derived) == 1


# the first pyramid level on raw grouped coordinates at KITTI's reach:
# x = [q - p, q] (models/pointnet2.py), |p| from 2 to 80 m, neighbours within
# about a metre; plain TF32 is off by ~1e-2 here
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,k,widths", [(1, 2048, 32, (8, 8, 16)), (2, 2048, 32, (8, 8, 16)),
                                          (1, 333, 32, (8, 8, 16)), (1, 64, 32, (128, 64))])
def test_mlp_maxpool_kernel_at_kittis_reach(cuda_device, full_fp32, rng, b, s, k, widths):
    direction = rng.normal(size=(b, s, 1, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    p = direction * rng.uniform(2.0, 80.0, size=(b, s, 1, 1))
    q = p + rng.normal(size=(b, s, k, 3)) * 0.5
    x = torch.from_numpy(np.concatenate([q - p, q], -1).astype(np.float32)).to(cuda_device)
    wb = _stack(rng, 6, widths, cuda_device)
    out = ops.mlp_maxpool(x, wb)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, mlp_maxpool_plain(x, wb), atol=3e-5, rtol=1e-4)


# main-path shapes and widths (as tools/time_point_kernels.py records them),
# then: odd widths (no multiple of 8: 5, 19, 33, 67) and a ragged last tile,
# K = 1 and K = 33 (a centre over three row tiles), one to three layers in
# every stack, a single centre, B = 9, and coordinates at KITTI's reach
# (|xyz| up to 80 m; ``reach`` 0 keeps the 10 m normal cloud). ``enc`` None
# is the path's one layer of D.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,k,cc,cg,emb,att,center,enc,reach", [
    (1, 256, 32, 64, 64, (128, 64, 64), (128, 64), False, None, 0),  # level-3 cross
    (1, 256, 4, 64, 64, None, (128, 64), True, None, 0),  # level-3 self
    (1, 1024, 6, 32, 32, (128, 64, 64), (128, 64), False, None, 0),
    (1, 2048, 6, 16, 16, (128, 64, 64), (128, 64), False, None, 0),
    (1, 2048, 4, 16, 64, None, (128, 64), True, None, 0),
    (9, 1024, 4, 32, 64, None, (128, 64), True, None, 0),
    (2, 341, 6, 16, 16, (48, 33), (20, 33), False, None, 0),  # odd widths, ragged last tile
    (2, 37, 7, 5, 12, None, (12,), True, None, 0),
    (1, 9, 40, 8, 8, (16,), (16,), True, None, 0),  # K above the row target: one centre per block
    (1, 256, 6, 64, 64, (128, 64, 64), (128, 64), False, None, 0),  # re-embedding, level 3
    (1, 1024, 4, 32, 64, None, (128, 64), True, None, 0),
    (1, 300, 1, 16, 16, (128, 64, 64), (128, 64), False, None, 0),  # K = 1
    (1, 50, 33, 32, 64, None, (128, 64), True, None, 0),  # K = 33
    (2, 101, 6, 5, 19, (33, 67), (19, 67), False, (5, 33), 0),  # widths 5, 19, 33, 67
    (1, 200, 6, 19, 33, (67, 19, 33), (5, 33, 33), False, (19, 67, 33), 0),  # three layers
    (1, 128, 4, 67, 33, None, (33, 19, 33), True, (5, 19, 67), 0),
    (1, 1, 6, 16, 16, (128, 64, 64), (128, 64), False, None, 0),  # a single centre
    (1, 1, 4, 64, 64, None, (128, 64), True, None, 0),
    (1, 1023, 6, 32, 32, (128, 64, 64), (128, 64), False, None, 0),  # ragged last tile
    (9, 256, 32, 64, 64, (128, 64, 64), (128, 64), False, None, 0),  # B = 9
    (9, 256, 4, 64, 64, None, (128, 64), True, None, 0),
    (1, 2048, 6, 16, 16, (128, 64, 64), (128, 64), False, None, 80.0),  # KITTI's reach
    (1, 256, 32, 64, 64, (128, 64, 64), (128, 64), False, None, 80.0),
    (1, 2048, 4, 16, 64, None, (128, 64), True, None, 80.0),
])
def test_attentive_aggregate_kernel_matches_plain(cuda_device, full_fp32, rng, b, s, k, cc, cg,
                                                  emb, att, center, enc, reach):
    if reach:
        direction = rng.normal(size=(b, s, 3))
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        radius = rng.uniform(2.0, reach, size=(b, s, 1))
        cxyz = torch.from_numpy((direction * radius).astype(np.float32)).to(cuda_device)
    else:
        cxyz = _rand(rng, cuda_device, b, s, 3, scale=10.0)
    gxyz = cxyz[:, :, None, :] + _rand(rng, cuda_device, b, s, k, 3)
    cfeat, gfeat = _rand(rng, cuda_device, b, s, cc), _rand(rng, cuda_device, b, s, k, cg)
    d = emb[-1] if emb else cg
    enc_wb = _stack(rng, 10, enc or (d,), cuda_device)
    emb_wb = _stack(rng, 10 + cc + cg, emb, cuda_device) if emb else None
    att_wb = _stack(rng, enc_wb[0][-1].shape[1] + (cc if center else 0) + d, att, cuda_device)
    args = (cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, center)
    out = ops.attentive_aggregate(*args)
    torch.cuda.synchronize()
    # 3xTF32 products (about 22 bits of each operand) summed in another
    # order than the library's fp32 matmul
    torch.testing.assert_close(out, attentive_aggregate_plain(*args), atol=5e-5, rtol=1e-4)


@pytest.mark.cuda
def test_launches_are_counted_and_bad_input_raises(cuda_device, rng):
    _cuda.reset_launch_counts()
    pts = torch.rand(1, 64, 3, device=cuda_device) + 0.1
    idx = tfps.furthest_point_sample(pts, 8)
    tgather.gather_points(pts, idx)
    knn(pts, pts, 4)
    x = torch.rand(1, 8, 4, 6, device=cuda_device)
    wb = _stack(rng, 6, (8,), cuda_device)
    ops.mlp_maxpool(x, wb)
    agg = (pts[:, :8], pts[:, :32].reshape(1, 8, 4, 3), x[:, :, 0], x,
           _stack(rng, 10, (6,), cuda_device), None, _stack(rng, 6 + 6 + 6, (6,), cuda_device), True)
    ops.attentive_aggregate(*agg)
    rows = torch.zeros(1, 64, dtype=torch.int32, device=cuda_device)
    tgather.scatter_add_rows(pts, rows, 8)
    once = {"fps": 1, "knn": 1, "gather": 1, "scatter_add": 1, "mlp_maxpool": 1,
            "attentive_aggregate": 1}
    assert _cuda.launch_counts() == once
    with pytest.raises(TypeError):
        tgather.gather_points(pts.double(), idx)
    with pytest.raises(TypeError):
        tgather.scatter_add_rows(pts.double(), rows, 8)
    with pytest.raises(ValueError):  # a view: the kernel takes contiguous rows
        tgather.scatter_add_rows(pts.transpose(1, 2), rows[:, :3].contiguous(), 8)
    with pytest.raises(ValueError):
        knn(pts, pts, 33)  # above the kernel's sorted-list size
    with pytest.raises(TypeError):
        ops.mlp_maxpool(x.double(), wb)
    with pytest.raises(ValueError):
        ops.mlp_maxpool(x, _stack(rng, 7, (8,), cuda_device))  # Cin does not chain
    with pytest.raises(ValueError):  # a layer wider than the kernel's 128 columns
        ops.mlp_maxpool(x, _stack(rng, 6, (130,), cuda_device))
    with pytest.raises(ValueError):  # attention width differs from the embedding's
        ops.attentive_aggregate(*agg[:6], _stack(rng, 18, (5,), cuda_device), True)
    with pytest.raises(ValueError):  # a layer wider than the kernel's 128 columns
        ops.attentive_aggregate(*agg[:6], _stack(rng, 18, (130, 6), cuda_device), True)
    with pytest.raises(ValueError):  # parameters left on the CPU
        ops.mlp_maxpool(x, _stack(rng, 6, (8,), "cpu"))
    assert _cuda.launch_counts() == once
