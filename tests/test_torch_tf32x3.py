"""The precision argument of the attentive aggregate's CUDA kernel, on the CPU.

``csrc/attentive_aggregate.cu`` multiplies on the tensor cores in 3xTF32:
every operand ``x`` is split into ``big = tf32(x)`` and ``small = tf32(x -
big)`` and each product is summed as ``big*small' + small*big' +
big*big'``, from weights that ``ops/tf32x3.py::pack_fragments`` pads and
lays out in mma fragment order. Here a plain PyTorch emulation of those
products (TF32 rounding done with integer operations on the float32 bits, as
``csrc/tf32x3.cuh::tf32_bits`` does), reading the weights back out of the
packed layout, runs the aggregate at the widths the full-width path
launches it with (as ``tools/time_point_kernels.py --ops
attentive_aggregate`` records them) and at KITTI's reach, and is held to the
port's plain version and to the reference's Pallas kernel (interpret mode)
at the kernel's own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.ops.costvolume import ENC_WIDTH, attentive_aggregate_plain
from pwclonet_pylidarslam_torch.ops.tf32x3 import pack_fragments, pad8, tile_centres
from pwclonet_pylidarslam_tpu.ops.pallas.costvolume_kernel import attentive_aggregate_pallas

AGG_TOL = dict(atol=5e-5, rtol=1e-4)  # the kernel's bar against the plain version
D = 64
# (K, Cc, Cg, cross) of the eight launches of a fused forward (the self
# stage at level 3 twice); every stack as the path has it: enc (64,), emb
# (128, 64, 64), att (128, 64)
PATH_WIDTHS = [(32, 64, 64, True), (4, 64, 64, False), (6, 64, 64, True), (6, 32, 32, True),
               (4, 32, 64, False), (6, 16, 16, True), (4, 16, 64, False)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero: on the float's bits, add half the unit of the 13
    dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & -(1 << 13)).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(big, small)``: ``big = tf32(x)``, ``small = tf32(x - big)``."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _stack(rng, cin, widths):
    ws, bs = [], []
    for cout in widths:
        ws.append(torch.from_numpy((rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)))
        bs.append(torch.from_numpy((rng.normal(size=cout) * 0.3).astype(np.float32)))
        cin = cout
    return tuple(ws), tuple(bs)


def _unpack(buf, parts, widths):
    """The packed stack back as ``[(w (Kp, Np), bias (Np,))]``."""
    layers, off = [], 0
    for cout in widths:
        kp, np_ = sum(pad8(p) for p in parts), pad8(cout)
        n = kp * np_
        # (s, j, g, t, h) -> (8s + 4h + t, 8j + g)
        frags = buf[off:off + n].view(kp // 8, np_ // 8, 8, 4, 2)
        layers.append((frags.permute(0, 4, 3, 1, 2).reshape(kp, np_), buf[off + n:off + n + np_]))
        off, parts = off + n + np_, (cout,)
    assert off == buf.numel()
    return layers


def test_tf32_round_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0 ** -23, -(1.0 + one_ulp / 2),
                      1.0 + 1.5 * one_ulp, 3.0e-3, -7.25e4, 0.0], dtype=torch.float32)
    expect = [1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + 2 * one_ulp]
    out = tf32_round(x)
    assert out[:5].tolist() == expect
    assert torch.all((out.view(torch.int32) & 0x1FFF) == 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32))
    big, small = tf32_split(x)
    assert torch.all((small.view(torch.int32) & 0x1FFF) == 0)
    # big to half a TF32 ulp of x; the rest to half a TF32 ulp of the small part
    assert torch.all((x - big).abs() <= x.abs() * 2.0 ** -11)
    assert torch.all((x.double() - big.double() - small.double()).abs() <= x.abs().double() * 2.0 ** -21)


def test_pack_fragments_places_every_weight_where_the_kernel_reads_it(rng):
    parts, widths = (10, 5, 19), (33, 67)
    ws, bs = _stack(rng, sum(parts), widths)
    buf = pack_fragments(ws, bs, parts)
    # layer 0: parts padded to 16 + 8 + 24 rows, 33 columns to 40; layer 1: 40 x 72
    assert buf.dtype == torch.float32 and buf.numel() == (48 * 40 + 40) + (40 * 72 + 72)
    # lane (g, t) of k-step s and n-tile j: its two floats, read one by one
    kp, np_ = 48, 40
    w0 = torch.zeros(kp, np_)
    w0[0:10, :33], w0[16:21, :33], w0[24:43, :33] = ws[0][0:10], ws[0][10:15], ws[0][15:34]
    for s, j, g, t in [(0, 0, 0, 0), (1, 3, 5, 2), (5, 4, 7, 3), (2, 1, 3, 1)]:
        at = ((s * (np_ // 8) + j) * 32 + g * 4 + t) * 2
        assert buf[at:at + 2].tolist() == [w0[8 * s + t, 8 * j + g].item(),
                                           w0[8 * s + t + 4, 8 * j + g].item()]
    # round trip: every weight in place, padding zero, bias in place
    layers = _unpack(buf, parts, widths)
    for (w_pad, bias), w, b, lp in zip(layers, ws, bs, (parts, (33,))):
        rows = torch.cat([torch.arange(o, o + p) for o, p in
                          zip(np.cumsum([0, *[pad8(p) for p in lp[:-1]]]), lp)])
        assert torch.equal(w_pad[rows][:, :w.shape[1]], w)
        pad_rows = torch.ones(w_pad.shape[0], dtype=torch.bool)
        pad_rows[rows] = False
        assert torch.all(w_pad[pad_rows] == 0) and torch.all(w_pad[:, w.shape[1]:] == 0)
        assert torch.equal(bias[:b.numel()], b) and torch.all(bias[b.numel():] == 0)


@pytest.mark.parametrize("centres,k,sms,expect", [
    (256, 4, 132, 4),  # 1,024 rows: 16-row tiles, 64 blocks
    (1024, 4, 132, 8),  # 4,096 rows: 32-row tiles, 128 blocks
    (256, 32, 132, 2),  # 8,192 rows: 64-row tiles, 128 blocks
    (2048, 6, 132, 10),  # 12,288 rows: 64-row tiles (60 rows, padded to 64)
    (1024, 6, 132, 10),
    (256, 6, 132, 2),  # 1,536 rows: 16-row tiles (12 rows), 128 blocks
    (9, 40, 132, 1),  # a centre longer than the tile: one a block
    (100000, 4, 132, 16),  # never above 64 rows
])
def test_tile_centres(centres, k, sms, expect):
    assert tile_centres(centres, k, sms) == expect


def _emulated_layer(inputs, layer):
    w, bias = layer
    a = torch.cat([torch.nn.functional.pad(x, (0, pad8(x.shape[-1]) - x.shape[-1]))
                   for x in inputs], dim=-1)
    (big_a, small_a), (big_w, small_w) = tf32_split(a), tf32_split(w)
    return torch.relu(bias + (big_a @ small_w + small_a @ big_w + big_a @ big_w))


def _emulated_aggregate(cxyz, gxyz, cfeat, gfeat, enc_wb, emb_wb, att_wb, center):
    """The kernel's arithmetic: every layer's products in 3xTF32, from the
    weights read back out of the packed layout, summed in fp32."""
    p = cxyz[:, :, None, :].expand(gxyz.shape)
    diff = gxyz - p
    enc = torch.cat([p, gxyz, diff, torch.sqrt((diff * diff).sum(-1, keepdim=True) + 1e-20)], -1)
    cf = cfeat[:, :, None, :].expand(*gfeat.shape[:3], cfeat.shape[-1])

    def run(wb, parts, inputs):
        layers = _unpack(pack_fragments(*wb, parts), parts, [w.shape[1] for w in wb[0]])
        h = _emulated_layer(inputs, layers[0])
        for layer in layers[1:]:
            h = _emulated_layer([h], layer)
        return h

    cc, cg = cfeat.shape[-1], gfeat.shape[-1]
    emb = gfeat if emb_wb is None else run(emb_wb, (ENC_WIDTH, cc, cg), [enc, cf, gfeat])
    e = run(enc_wb, (ENC_WIDTH,), [enc])
    d, de = emb.shape[-1], e.shape[-1]
    att = run(att_wb, (de, cc, d) if center else (de, d), [e, cf, emb] if center else [e, emb])
    att = torch.exp(att - att.amax(dim=-2, keepdim=True))
    return torch.sum(att / att.sum(dim=-2, keepdim=True) * emb, dim=-2)


@pytest.mark.parametrize("k,cc,cg,cross", PATH_WIDTHS)
def test_emulated_tf32x3_aggregate_matches_plain_and_pallas(rng, k, cc, cg, cross):
    s = 48
    # centres at KITTI's reach: uniform in direction, 2 to 80 m out
    direction = rng.normal(size=(1, s, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    cxyz = (direction * rng.uniform(2.0, 80.0, size=(1, s, 1))).astype(np.float32)
    gxyz = (cxyz[:, :, None, :] + rng.normal(size=(1, s, k, 3))).astype(np.float32)
    cfeat = rng.normal(size=(1, s, cc)).astype(np.float32)
    gfeat = rng.normal(size=(1, s, k, cg)).astype(np.float32)
    enc_wb = _stack(rng, ENC_WIDTH, (D,))
    emb_wb = _stack(rng, ENC_WIDTH + cc + cg, (128, 64, D)) if cross else None
    att_wb = _stack(rng, D + (0 if cross else cc) + D, (128, D))
    arrays = [torch.from_numpy(a) for a in (cxyz, gxyz, cfeat, gfeat)]
    args = (*arrays, enc_wb, emb_wb, att_wb, not cross)
    emulated = _emulated_aggregate(*args)
    torch.testing.assert_close(emulated, attentive_aggregate_plain(*args), **AGG_TOL)

    def j(wb):
        return None if wb is None else tuple(tuple(jnp.asarray(t.numpy()) for t in part)
                                             for part in wb)

    ref = attentive_aggregate_pallas(*(jnp.asarray(a) for a in (cxyz, gxyz, cfeat, gfeat)),
                                     j(enc_wb), j(emb_wb), j(att_wb), not cross)
    np.testing.assert_allclose(emulated.numpy(), np.asarray(ref), **AGG_TOL)


def test_a_folded_stack_is_laid_out_once():
    from pwclonet_pylidarslam_torch.models.layers import PointMLP
    from pwclonet_pylidarslam_torch.ops.tf32x3 import packed_fragments

    mlp = PointMLP(10 + 16 + 16, (128, 64, 64), generator=torch.Generator().manual_seed(0))
    wb = mlp.folded()
    assert mlp.folded() is wb  # the fold is kept while the parameters stand
    cpu = torch.device("cpu")
    packed = packed_fragments(wb, (ENC_WIDTH, 16, 16), cpu)
    assert packed_fragments(wb, (ENC_WIDTH, 16, 16), cpu) is packed
    assert torch.equal(packed, pack_fragments(*wb, (ENC_WIDTH, 16, 16)))
    # another split of the first layer's rows is another layout
    assert packed_fragments(wb, (ENC_WIDTH, 8, 24), cpu) is not packed
    # a plain (weights, biases) pair is laid out on each call, as it may change
    plain = (tuple(wb[0]), tuple(wb[1]))
    parts = (ENC_WIDTH, 16, 16)
    assert packed_fragments(plain, parts, cpu) is not packed_fragments(plain, parts, cpu)
