"""Port parity of the fused eval path: ``fold_bn``, ``mlp_maxpool`` and
``attentive_aggregate`` of ``pwclonet_pylidarslam_torch.ops`` against the
reference's Pallas kernels (which select interpret mode off-TPU), and the
port's modules with ``fused_eval=True`` against its own unfused modules on
the same converted Flax variables. All on the CPU, where the wrappers run
their plain versions; the CUDA kernels are held against those in
``test_torch_cuda.py``. Every array is built as explicit float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.models import load_flax_variables
from pwclonet_pylidarslam_torch.models.costvolume import CostVolume
from pwclonet_pylidarslam_torch.models.layers import PointMLP
from pwclonet_pylidarslam_torch.models.pointnet2 import SetConv, SetUpConv
from pwclonet_pylidarslam_torch.ops.costvolume import attentive_aggregate_plain
from pwclonet_pylidarslam_torch.ops.mlp import check_stack, mlp_maxpool_plain
from pwclonet_pylidarslam_torch.ops.tf32x3 import pack_fragments, packed_fragments
from pwclonet_pylidarslam_tpu.models.costvolume import CostVolume as JCostVolume
from pwclonet_pylidarslam_tpu.models.layers import PointMLP as JPointMLP
from pwclonet_pylidarslam_tpu.models.pointnet2 import SetConv as JSetConv
from pwclonet_pylidarslam_tpu.models.pointnet2 import SetUpConv as JSetUpConv
from pwclonet_pylidarslam_tpu.ops.pallas.costvolume_kernel import attentive_aggregate_pallas
from pwclonet_pylidarslam_tpu.ops.pallas.mlp_kernel import fold_bn as jfold_bn
from pwclonet_pylidarslam_tpu.ops.pallas.mlp_kernel import mlp_maxpool_pallas
from test_torch_models import _f32, _torch, _variables

# the reference's own bars for its fused kernels against its unfused graph
MLP_TOL = dict(atol=3e-5, rtol=1e-4)
AGG_TOL = dict(atol=5e-5, rtol=1e-4)


def _stack(rng, cin, widths):
    """Random folded ``(weights, biases)`` of a stack, float32 numpy."""
    ws, bs = [], []
    for cout in widths:
        ws.append(_f32(rng, cin, cout, scale=1.0 / np.sqrt(cin)))
        bs.append(_f32(rng, cout, scale=0.3))
        cin = cout
    return tuple(ws), tuple(bs)


def _t(wb):
    return tuple(tuple(torch.from_numpy(a) for a in part) for part in wb)


def _j(wb):
    return tuple(tuple(jnp.asarray(a) for a in part) for part in wb)


def test_fold_bn(rng):
    kernel, scale, bias, mean = (_f32(rng, 11, 16), _f32(rng, 16), _f32(rng, 16), _f32(rng, 16))
    var = np.abs(_f32(rng, 16)) + 0.1
    ref_w, ref_b = jfold_bn(*(jnp.asarray(a) for a in (kernel, scale, bias, mean, var)), 1e-5)
    w, b = ops.fold_bn(*(torch.from_numpy(a) for a in (kernel, scale, bias, mean, var)), 1e-5)
    assert w.dtype == b.dtype == torch.float32
    # the same float32 expression; rsqrt may differ in the last bit
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,widths", [((2, 40, 8, 11), (16, 8, 32)), ((1, 333, 32, 7), (8, 16))])
def test_mlp_maxpool_matches_pallas(rng, shape, widths):
    x = _f32(rng, *shape)
    wb = _stack(rng, shape[-1], widths)
    ref = np.asarray(mlp_maxpool_pallas(jnp.asarray(x), *_j(wb)))
    out = ops.mlp_maxpool(torch.from_numpy(x), _t(wb))
    assert out.shape == shape[:2] + (widths[-1],) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **MLP_TOL)


@pytest.mark.parametrize("s,k", [(64, 8), (340, 6)])
@pytest.mark.parametrize("with_emb", [True, False], ids=["cross", "self"])
def test_attentive_aggregate_matches_pallas(rng, with_emb, s, k):
    cc, d = 16, 32
    cg = 16 if with_emb else d  # the self stage aggregates the grouped embeddings themselves
    cxyz, gxyz = _f32(rng, 2, s, 3, scale=5.0), _f32(rng, 2, s, k, 3, scale=5.0)
    cfeat, gfeat = _f32(rng, 2, s, cc), _f32(rng, 2, s, k, cg)
    enc_wb = _stack(rng, 10, (d,))
    emb_wb = _stack(rng, 10 + cc + cg, (48, 32, d)) if with_emb else None
    att_wb = _stack(rng, d + d if with_emb else d + cc + d, (48, d))
    ref = attentive_aggregate_pallas(
        *(jnp.asarray(a) for a in (cxyz, gxyz, cfeat, gfeat)), _j(enc_wb),
        None if emb_wb is None else _j(emb_wb), _j(att_wb), att_includes_center=not with_emb)
    out = ops.attentive_aggregate(
        *(torch.from_numpy(a) for a in (cxyz, gxyz, cfeat, gfeat)), _t(enc_wb),
        None if emb_wb is None else _t(emb_wb), _t(att_wb), att_includes_center=not with_emb)
    assert out.shape == (2, s, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AGG_TOL)


def test_cpu_wrappers_run_the_plain_versions(rng):
    x = torch.from_numpy(_f32(rng, 1, 5, 3, 4))
    wb = _t(_stack(rng, 4, (6,)))
    assert torch.equal(ops.mlp_maxpool(x, wb), mlp_maxpool_plain(x, wb))
    cxyz, gxyz = torch.from_numpy(_f32(rng, 1, 5, 3)), torch.from_numpy(_f32(rng, 1, 5, 3, 3))
    cfeat, gfeat = torch.from_numpy(_f32(rng, 1, 5, 2)), torch.from_numpy(_f32(rng, 1, 5, 3, 6))
    enc_wb, att_wb = _t(_stack(rng, 10, (6,))), _t(_stack(rng, 6 + 2 + 6, (6,)))
    args = (cxyz, gxyz, cfeat, gfeat, enc_wb, None, att_wb, True)
    out = ops.attentive_aggregate(*args)
    assert torch.equal(out, attentive_aggregate_plain(*args))
    # softmax weights sum to 1: the aggregate lies within the neighbours' range
    assert torch.all(out <= gfeat.amax(dim=2) + 1e-6) and torch.all(out >= gfeat.amin(dim=2) - 1e-6)


def test_fold_stack_packs_what_the_kernels_read(rng):
    mod = PointMLP(7, (8, 16))
    with torch.no_grad():
        for name, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            t.copy_(torch.from_numpy(np.abs(_f32(rng, *t.shape)) + 0.1))
    weights, biases = mod.folded()
    assert check_stack("stack", weights, biases, 7) == (8, 16)
    for i, (w, b) in enumerate(zip(weights, biases)):
        ref_w, ref_b = ops.fold_bn(*(getattr(mod, f"{n}_{i}") for n in
                                     ("kernel", "scale", "bias", "mean", "var")), mod.eps)
        assert torch.equal(w, ref_w) and torch.equal(b, ref_b)
    # the kernel's layout of the fold (mma fragment order), made once and kept with it
    cpu = torch.device("cpu")
    packed = packed_fragments(mod.folded(), (7,), cpu)
    assert torch.equal(packed, pack_fragments(weights, biases, (7,)))
    assert packed_fragments(mod.folded(), (7,), cpu) is packed
    with pytest.raises(TypeError, match="float32"):
        packed_fragments(([w.double() for w in weights], biases), (7,), cpu)


def test_check_stack_raises_on_a_stack_that_does_not_chain(rng):
    ws, bs = _t(_stack(rng, 7, (8, 16)))
    with pytest.raises(ValueError, match="layer 0"):
        check_stack("stack", ws, bs, 9)
    with pytest.raises(ValueError, match="layer 1"):
        check_stack("stack", (ws[0], ws[1][:5]), bs, 7)
    with pytest.raises(ValueError, match="1 to 3 layers"):
        check_stack("stack", ws * 2, bs * 2, 7)
    with pytest.raises(ValueError, match="1 to 3 layers"):
        check_stack("stack", (), (), 7)


def test_point_mlp_fused(rng):
    x = _f32(rng, 2, 12, 8, 11)
    vs = _variables(JPointMLP((16, 8, 32)), rng, x)
    mod = load_flax_variables(PointMLP(11, (16, 8, 32)), vs)
    ref = _torch(mod, x, maxpool=True)
    np.testing.assert_allclose(_torch(mod, x, maxpool=True, fused=True), ref, **MLP_TOL)
    # fused only takes the (B, S, K, C) max-pool block: other calls are unfused
    assert np.array_equal(_torch(mod, x, maxpool=False, fused=True), _torch(mod, x, maxpool=False))
    assert np.array_equal(_torch(mod, x[0], maxpool=True, fused=True), _torch(mod, x[0], maxpool=True))


@pytest.mark.parametrize("with_features", [False, True])
def test_set_conv_fused(rng, with_features):
    xyz = _f32(rng, 2, 128, 3, scale=5.0)
    feat = _f32(rng, 2, 128, 16) if with_features else None
    vs = _variables(JSetConv(32, 8, (16, 16, 32)), rng, xyz, feat)
    cin = 16 if with_features else None
    base = load_flax_variables(SetConv(cin, 32, 8, (16, 16, 32)), vs)
    fused = load_flax_variables(SetConv(cin, 32, 8, (16, 16, 32), fused_eval=True), vs)
    ref_xyz, ref_feat = _torch(base, xyz, feat)
    out_xyz, out_feat = _torch(fused, xyz, feat)
    np.testing.assert_array_equal(out_xyz, ref_xyz)
    np.testing.assert_allclose(out_feat, ref_feat, **MLP_TOL)


def test_set_up_conv_fused(rng):
    fine, coarse = _f32(rng, 2, 64, 3, scale=5.0), _f32(rng, 2, 16, 3, scale=5.0)
    ffeat, cfeat = _f32(rng, 2, 64, 32), _f32(rng, 2, 16, 64)
    vs = _variables(JSetUpConv(nsample=8, mlp=(128, 64), post_mlp=(64,)), rng,
                    fine, coarse, ffeat, cfeat)
    base = load_flax_variables(SetUpConv(64, 32, 8, (128, 64), (64,)), vs)
    fused = load_flax_variables(SetUpConv(64, 32, 8, (128, 64), (64,), fused_eval=True), vs)
    np.testing.assert_allclose(_torch(fused, fine, coarse, ffeat, cfeat),
                               _torch(base, fine, coarse, ffeat, cfeat), **MLP_TOL)


@pytest.mark.parametrize("nsample_q", [6, 32])
def test_cost_volume_fused(rng, nsample_q):
    xyz1, xyz2 = _f32(rng, 2, 48, 3, scale=5.0), _f32(rng, 2, 64, 3, scale=5.0)
    f1, f2 = _f32(rng, 2, 48, 32), _f32(rng, 2, 64, 32)
    vs = _variables(JCostVolume(nsample=4, nsample_q=nsample_q), rng, xyz1, f1, xyz2, f2)
    base = load_flax_variables(CostVolume(32, 32, nsample=4, nsample_q=nsample_q), vs)
    fused = load_flax_variables(
        CostVolume(32, 32, nsample=4, nsample_q=nsample_q, fused_eval=True), vs)
    np.testing.assert_allclose(_torch(fused, xyz1, f1, xyz2, f2),
                               _torch(base, xyz1, f1, xyz2, f2), **AGG_TOL)


def test_fold_is_kept_until_the_weights_change(rng):
    x = _f32(rng, 1, 6, 4, 5)
    vs_a = _variables(JPointMLP((8, 8)), rng, x)
    vs_b = _variables(JPointMLP((8, 8)), np.random.default_rng(7), x)
    mod = load_flax_variables(PointMLP(5, (8, 8)), vs_a)
    first = mod.folded()
    assert mod.folded() is first  # folded once
    out_a = _torch(mod, x, maxpool=True, fused=True)
    load_flax_variables(mod, vs_b)  # writes in place: the versions move
    assert mod.folded() is not first
    out_b = _torch(mod, x, maxpool=True, fused=True)
    np.testing.assert_allclose(out_b, _torch(mod, x, maxpool=True), **MLP_TOL)
    assert np.abs(out_a - out_b).max() > 1e-3
    # replaced tensors (what .to(device) does) are noticed by their address
    kept = mod.folded()
    mod.kernel_0.data = mod.kernel_0.data.clone()
    assert mod.folded() is not kept
    # a state dict load is an in-place write too
    kept = mod.folded()
    mod.load_state_dict(load_flax_variables(PointMLP(5, (8, 8)), vs_a).state_dict())
    assert mod.folded() is not kept
    np.testing.assert_allclose(_torch(mod, x, maxpool=True, fused=True), out_a, **MLP_TOL)


def test_fold_of_inference_tensors_is_made_anew(rng):
    """Parameters created under ``torch.inference_mode()`` have no version
    counter to watch: every call folds again, so a write is never missed."""
    x = torch.from_numpy(_f32(rng, 1, 6, 4, 5))
    with torch.inference_mode():
        mod = PointMLP(5, (8, 8))
        first = mod.folded()
        before = mod(x, maxpool=True, fused=True)
        mod.kernel_0.mul_(2.0)
        assert mod.folded() is not first
        after = mod(x, maxpool=True, fused=True)
        torch.testing.assert_close(after, mod(x, maxpool=True), atol=3e-5, rtol=1e-4)
    assert (after - before).abs().max() > 1e-3


@pytest.mark.parametrize("maxpool", [False, True])
def test_point_mlp_bfloat16(rng, maxpool):
    x = _f32(rng, 2, 12, 8, 11)
    jmod = JPointMLP((16, 8, 32), dtype=jnp.bfloat16)
    vs = _variables(JPointMLP((16, 8, 32)), rng, x)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False, maxpool=maxpool))(vs, jnp.asarray(x))
    mod = load_flax_variables(PointMLP(11, (16, 8, 32), dtype=torch.bfloat16), vs)
    out = _torch(mod, x, maxpool=maxpool)
    assert out.dtype == np.float32 and np.asarray(ref).dtype == np.float32
    # found: the two agree to the bit on the CPU (both accumulate in float32
    # and round to bf16 at the same places). The bar allows one bf16 step
    # (8 mantissa bits: 2^-6 at magnitudes in [2, 4)) for another backend.
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-2, rtol=1e-2)
    f32 = _torch(load_flax_variables(PointMLP(11, (16, 8, 32)), vs), x, maxpool=maxpool)
    assert 1e-4 < np.abs(out - f32).max() < 0.3  # bf16 did run, and stays near float32
