"""Port parity: the row scatter-add (the gather's backward) of
``pwclonet_pylidarslam_torch.ops.gather`` against the reference's
``scatter_add_rows`` (its Pallas kernel in interpret mode) and against
``.at[].add``, and the gather's gradient against ``jax.grad``. On the CPU
the port runs its plain versions; the CUDA kernel is held against them on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.ops.gather import scatter_add_rows_plain
from pwclonet_pylidarslam_tpu.ops.gather import gather_points as j_gather_points
from pwclonet_pylidarslam_tpu.ops.pallas.gather_kernel import scatter_add_rows as j_scatter_add_rows


def _case(seed, b, n, m, c, targets=None):
    rng = np.random.default_rng(seed)
    upd = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = rng.integers(0, n if targets is None else targets, size=(b, m)).astype(np.int32)
    return upd, idx


# the shapes of the reference's own scatter and gradient tests, one with M no
# multiple of 128 (the reference then takes its .at[].add fallback), one with
# a heavily repeated index (three rows take all 640 updates), and a skewed one
# whose segments run past a warp's 32 (five rows take ~260 updates each)
@pytest.mark.parametrize("b,n,m,c,targets", [
    (2, 128, 256, 5, None), (2, 64, 128, 4, None), (2, 100, 333, 7, None), (2, 64, 640, 6, 3),
    (2, 16, 1280, 3, 5),
])
def test_scatter_add_matches_reference(b, n, m, c, targets):
    upd, idx = _case(1, b, n, m, c, targets)
    kernel = np.asarray(j_scatter_add_rows(jnp.asarray(upd), jnp.asarray(idx), n, interpret=True))
    oracle = np.asarray(jnp.zeros((b, n, c), jnp.float32).at[
        jnp.arange(b)[:, None], jnp.asarray(idx)].add(jnp.asarray(upd)))
    for fn in (scatter_add_rows_plain, ops.scatter_add_rows):
        out = fn(torch.from_numpy(upd), torch.from_numpy(idx), n).numpy()
        assert out.shape == (b, n, c) and out.dtype == np.float32
        # sums of up to a few hundred unit-scale terms in another order
        np.testing.assert_allclose(out, kernel, atol=1e-5 * max(1.0, m / n / 8))
        np.testing.assert_allclose(out, oracle, atol=1e-5 * max(1.0, m / n / 8))


def test_scatter_add_is_a_sequential_loop_over_m():
    """The order the CUDA kernel promises is the plain version's on the CPU:
    rows of one destination are added in ascending m, starting from zero."""
    upd, idx = _case(2, 2, 16, 200, 3)
    want = np.zeros((2, 16, 3), np.float32)
    for b in range(2):
        for m in range(200):
            want[b, idx[b, m]] += upd[b, m]
    out = scatter_add_rows_plain(torch.from_numpy(upd), torch.from_numpy(idx), 16).numpy()
    np.testing.assert_array_equal(out, want)


def test_gather_gradient_matches_jax_grad():
    rng = np.random.default_rng(2)
    b, n, m, c = 2, 64, 128, 4
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m)).astype(np.int32)
    want = jax.grad(lambda p: jnp.sum(j_gather_points(p, jnp.asarray(idx)) ** 2))(jnp.asarray(src))
    t_src = torch.from_numpy(src).requires_grad_()
    t_idx = torch.from_numpy(idx)
    (ops.gather_points(t_src, t_idx) ** 2).sum().backward()
    np.testing.assert_allclose(t_src.grad.numpy(), np.asarray(want), atol=1e-5)
    assert t_idx.grad is None and not t_idx.requires_grad
    # the gradient is the scatter-add of the incoming gradient
    gathered = ops.gather_points(t_src.detach(), t_idx)
    torch.testing.assert_close(t_src.grad, ops.scatter_add_rows(2.0 * gathered, t_idx, n),
                               atol=1e-6, rtol=0)


def test_grouping_gradient_through_one_concatenated_gather():
    """``group_points_multi`` differentiates into each of its sources."""
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.normal(size=(2, 32, 3)).astype(np.float32)).requires_grad_()
    feat = torch.from_numpy(rng.normal(size=(2, 32, 5)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 32, size=(2, 10, 4)).astype(np.int32))
    g_xyz, g_feat = ops.group_points_multi(idx, xyz, feat)
    (g_xyz.sum() * 2.0 + (g_feat ** 2).sum()).backward()
    counts = scatter_add_rows_plain(torch.ones(2, 40, 1), idx.reshape(2, 40), 32)
    torch.testing.assert_close(xyz.grad, (2.0 * counts).expand(2, 32, 3))
    torch.testing.assert_close(feat.grad, 2.0 * feat.detach() * counts)


def test_knn_and_fps_results_never_require_grad():
    pts = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(0)).requires_grad_()
    moved = pts * 1.5 + 0.1  # a point set with a graph behind it, like the warped points
    dists, idx = ops.knn(moved, pts, 4)
    picks = ops.furthest_point_sample(moved, 8)
    assert not dists.requires_grad and dists.grad_fn is None
    assert not idx.requires_grad and not picks.requires_grad
    assert idx.dtype == picks.dtype == torch.int32
