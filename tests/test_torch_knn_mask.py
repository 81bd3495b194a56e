"""Masked kNN of the port against the reference's exact path on the CPU.

The reference's ``ops/knn.py::knn`` with ``approx=False`` takes two branches:
one distance matrix and one top-k for N <= 2048, and a scan over tiles of
2048 reference points with a running top-k merge above that. Both are held
against the port's :func:`knn` on the same float32 numpy inputs, with query
and reference masks: rows with fewer than k valid refs, with none, masked
queries, and k > N. Indices are equal; distances agree to 1e-5 at unit
scale (XLA's CPU dot fuses multiply-adds, the port rounds each product:
ROADMAP Queue C, cross-term rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.ops.knn import fix_up, knn, knn_plain
from pwclonet_pylidarslam_tpu import ops as jops


def _masks(rng, b, s, n, k):
    """Reference masks: sample 0 with ~30 % masked, sample 1 with fewer than
    k valid refs, sample 2 with none; ~20 % of queries masked."""
    ref_mask = (rng.uniform(size=(b, n)) > 0.3).astype(np.float32)
    ref_mask[1] = 0.0
    ref_mask[1, rng.choice(n, max(1, min(k - 1, n // 2)), replace=False)] = 1.0
    ref_mask[2] = 0.0
    query_mask = (rng.uniform(size=(b, s)) > 0.2).astype(np.float32)
    return query_mask, ref_mask


def _both(q, r, k, qm, rm):
    jd, ji = jops.knn(jnp.asarray(q), jnp.asarray(r), k,
                      None if qm is None else jnp.asarray(qm),
                      None if rm is None else jnp.asarray(rm), approx=False)
    d, i = knn(torch.from_numpy(q), torch.from_numpy(r), k,
               None if qm is None else torch.from_numpy(qm),
               None if rm is None else torch.from_numpy(rm))
    return (np.asarray(jd), np.asarray(ji)), (d.numpy(), i.numpy())


@pytest.mark.parametrize("n", [700, 2048 + 1500], ids=["untiled", "tiled"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("which", ["ref", "query", "both"])
def test_masked_knn_matches_reference(rng, n, k, which):
    b, s = 3, 96
    q = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    qm, rm = _masks(rng, b, s, n, k)
    qm = qm if which in ("query", "both") else None
    rm = rm if which in ("ref", "both") else None
    (jd, ji), (d, i) = _both(q, r, k, qm, rm)
    assert i.dtype == np.int32 and d.dtype == np.float32
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, atol=1e-5, rtol=0)
    if rm is not None:
        # a masked ref is never picked while a valid one is left; a sample
        # without one gets 1e10 at index 0 (or 0 / 0 where the query is masked)
        picked_ok = np.take_along_axis(rm[0][None].repeat(s, 0), i[0].astype(np.int64), 1)
        live = np.ones(s, bool) if qm is None else qm[0] > 0
        assert np.all(picked_ok[live] == 1.0)
        expect = np.where(live if qm is None else qm[2] > 0, 1e10, 0.0)
        np.testing.assert_array_equal(d[2], np.broadcast_to(expect[:, None], (s, k)))
        np.testing.assert_array_equal(i[2], 0)
    if qm is not None:
        assert np.all(i[qm == 0] == 0) and np.all(d[qm == 0] == 0.0)


def test_fewer_valid_refs_than_k_repeat_the_nearest_valid_hit(rng):
    q = rng.uniform(-1, 1, (1, 20, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    rm = np.zeros((1, 300), np.float32)
    valid = np.array([3, 77, 150])
    rm[0, valid] = 1.0
    (jd, ji), (d, i) = _both(q, r, 8, None, rm)
    np.testing.assert_array_equal(i, ji)
    assert set(np.unique(i)) <= set(valid)
    # slots 3.. repeat slot 0
    np.testing.assert_array_equal(i[..., 3:], np.broadcast_to(i[..., :1], i[..., 3:].shape))
    np.testing.assert_array_equal(d[..., 3:], np.broadcast_to(d[..., :1], d[..., 3:].shape))


@pytest.mark.parametrize("masked", [False, True])
def test_k_above_n_pads_with_masks(rng, masked):
    q = rng.uniform(-1, 1, (3, 12, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (3, 5, 3)).astype(np.float32)
    qm, rm = _masks(rng, 3, 12, 5, 8) if masked else (None, None)
    (jd, ji), (d, i) = _both(q, r, 8, qm, rm)
    assert i.shape == (3, 12, 8)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, atol=1e-5, rtol=0)


def test_plain_version_is_the_sort_then_the_fix_up(rng):
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    rm = torch.from_numpy((rng.uniform(size=(2, 64)) > 0.9).astype(np.float32))
    d, i = knn_plain(q, r, 16, ref_mask=rm)
    # every row of sample 0 has ~6 valid refs: after them, slot 0 repeats
    nvalid = int(rm[0].sum())
    assert 0 < nvalid < 16
    assert torch.equal(i[0, :, nvalid:], i[0, :, :1].expand(-1, 16 - nvalid))
    # unmasked: the fix-up leaves every real distance alone
    d0, i0 = knn_plain(q, r, 16)
    assert torch.equal(fix_up(d0, i0)[1], i0)
