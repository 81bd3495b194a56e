"""Port parity: the eval-mode PWCLO-Net modules of
``pwclonet_pylidarslam_torch.models`` against the Flax reference, with the
reference's variables converted by ``load_flax_variables``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig, load_flax_variables
from pwclonet_pylidarslam_torch.models.convert import flatten_variables
from pwclonet_pylidarslam_torch.models.costvolume import CostVolume
from pwclonet_pylidarslam_torch.models.layers import PointMLP
from pwclonet_pylidarslam_torch.models.pointnet2 import SetConv, SetUpConv
from pwclonet_pylidarslam_tpu.models import PWCLONet as JPWCLONet
from pwclonet_pylidarslam_tpu.models import PWCLONetConfig as JPWCLONetConfig
from pwclonet_pylidarslam_tpu.models.costvolume import CostVolume as JCostVolume
from pwclonet_pylidarslam_tpu.models.layers import PointMLP as JPointMLP
from pwclonet_pylidarslam_tpu.models.pointnet2 import SetConv as JSetConv
from pwclonet_pylidarslam_tpu.models.pointnet2 import SetUpConv as JSetUpConv

SMALL = dict(num_points=256, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))
MODULE_TOL = dict(atol=1e-5, rtol=1e-4)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _variables(module, rng, *args, **kw):
    """Flax init, cast to float32 numpy, batch_stats perturbed so that
    BatchNorm is not the identity."""
    keys = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
    init = jax.jit(lambda *xs: module.init(keys, *xs, train=False, **kw))
    vs = init(*(None if a is None else jnp.asarray(a) for a in args))
    vs = jax.tree.map(lambda a: np.asarray(a, np.float32), vs)
    stats = {}
    for path, a in flatten_variables(vs["batch_stats"]).items():
        shift = rng.normal(size=a.shape).astype(np.float32) * 0.3
        stats[path] = a + (np.abs(shift) if path.rsplit("/", 1)[-1].startswith("var") else shift)
    return {"params": vs["params"], "batch_stats": _unflatten(stats)}


def _unflatten(flat):
    out = {}
    for path, a in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def _apply(module, vs, *args, **kw):
    apply = jax.jit(lambda v, *xs: module.apply(v, *xs, train=False, **kw))
    out = apply(vs, *(None if a is None else jnp.asarray(a) for a in args))
    return jax.tree.map(np.asarray, out)


def _torch(module, *args, **kw):
    with torch.inference_mode():
        out = module(*(None if a is None else torch.from_numpy(a) for a in args), **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("maxpool", [False, True])
def test_point_mlp(rng, maxpool):
    x = _f32(rng, 2, 12, 8, 11)
    vs = _variables(JPointMLP((16, 8, 32)), rng, x)
    ref = _apply(JPointMLP((16, 8, 32)), vs, x, maxpool=maxpool)
    mod = load_flax_variables(PointMLP(11, (16, 8, 32)), vs)
    np.testing.assert_allclose(_torch(mod, x, maxpool=maxpool), ref, **MODULE_TOL)


@pytest.mark.parametrize("with_features", [False, True])
def test_set_conv(rng, with_features):
    xyz = _f32(rng, 2, 128, 3, scale=5.0)
    feat = _f32(rng, 2, 128, 16) if with_features else None
    jmod = JSetConv(32, 8, (16, 16, 32))
    vs = _variables(jmod, rng, xyz, feat)
    ref_xyz, ref_feat = _apply(jmod, vs, xyz, feat)
    mod = load_flax_variables(SetConv(16 if with_features else None, 32, 8, (16, 16, 32)), vs)
    out_xyz, out_feat = _torch(mod, xyz, feat)
    np.testing.assert_array_equal(out_xyz, ref_xyz)
    np.testing.assert_allclose(out_feat, ref_feat, **MODULE_TOL)


def test_set_up_conv(rng):
    fine, coarse = _f32(rng, 2, 64, 3, scale=5.0), _f32(rng, 2, 16, 3, scale=5.0)
    ffeat, cfeat = _f32(rng, 2, 64, 32), _f32(rng, 2, 16, 64)
    jmod = JSetUpConv(nsample=8, mlp=(128, 64), post_mlp=(64,))
    vs = _variables(jmod, rng, fine, coarse, ffeat, cfeat)
    ref = _apply(jmod, vs, fine, coarse, ffeat, cfeat)
    mod = load_flax_variables(SetUpConv(64, 32, 8, (128, 64), (64,)), vs)
    np.testing.assert_allclose(_torch(mod, fine, coarse, ffeat, cfeat), ref, **MODULE_TOL)


@pytest.mark.parametrize("nsample_q", [6, 32])
def test_cost_volume(rng, nsample_q):
    xyz1, xyz2 = _f32(rng, 2, 48, 3, scale=5.0), _f32(rng, 2, 64, 3, scale=5.0)
    f1, f2 = _f32(rng, 2, 48, 32), _f32(rng, 2, 64, 32)
    jmod = JCostVolume(nsample=4, nsample_q=nsample_q)
    vs = _variables(jmod, rng, xyz1, f1, xyz2, f2)
    ref = _apply(jmod, vs, xyz1, f1, xyz2, f2)
    mod = load_flax_variables(CostVolume(32, 32, nsample=4, nsample_q=nsample_q), vs)
    np.testing.assert_allclose(_torch(mod, xyz1, f1, xyz2, f2), ref, **MODULE_TOL)


@pytest.fixture(scope="module")
def small_net():
    """The small PWCLO-Net config, its perturbed Flax variables and inputs."""
    rng = np.random.default_rng(1)
    x1 = _f32(rng, 2, 256, 3, scale=8.0)
    x2 = (x1 + _f32(rng, 2, 256, 3, scale=0.05)).astype(np.float32)
    jnet = JPWCLONet(JPWCLONetConfig(**SMALL))
    vs = _variables(jnet, rng, x1, x2)
    return jnet, vs, x1, x2


@pytest.fixture(scope="module")
def small_net_reference(small_net):
    """The reference's unfused eval forward of ``small_net``, computed once."""
    jnet, vs, x1, x2 = small_net
    return _apply(jnet, vs, x1, x2)


def test_pwclonet_forward(small_net, small_net_reference):
    jnet, vs, x1, x2 = small_net
    ref_params, ref_aux = small_net_reference
    net = load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL), device="cpu"), vs)
    with torch.inference_mode():
        params, aux = net(torch.from_numpy(x1), torch.from_numpy(x2))
    assert params.shape == (2, 4, 7)
    np.testing.assert_allclose(params.numpy(), np.asarray(ref_params), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(aux["embedding_mask"].numpy(), np.asarray(ref_aux["embedding_mask"]),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(aux["point_cloud"].numpy(), np.asarray(ref_aux["point_cloud"]))


def _forward(net, x1, x2):
    with torch.inference_mode():
        params, aux = net(torch.from_numpy(x1), torch.from_numpy(x2))
    return params.numpy(), aux["embedding_mask"].numpy()


def test_pwclonet_fused_forward(small_net, small_net_reference):
    """``fused_eval=True`` (plain versions of the fused blocks on the CPU)
    against the reference's unfused forward, at the reference's own bar for
    its fused network."""
    _, vs, x1, x2 = small_net
    ref_params, ref_aux = small_net_reference
    net = load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL, fused_eval=True), device="cpu"), vs)
    params, mask = _forward(net, x1, x2)
    assert params.shape == (2, 4, 7)
    np.testing.assert_allclose(params, np.asarray(ref_params), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(mask, np.asarray(ref_aux["embedding_mask"]), atol=1e-4, rtol=1e-3)


def test_pwclonet_fused_forward_against_reference_fused(small_net):
    """Against the reference's own ``fused_eval=True`` forward (its Pallas
    kernels in interpret mode)."""
    _, vs, x1, x2 = small_net
    ref_params, _ = _apply(JPWCLONet(JPWCLONetConfig(**SMALL, fused_eval=True)), vs, x1, x2)
    net = load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL, fused_eval=True), device="cpu"), vs)
    np.testing.assert_allclose(_forward(net, x1, x2)[0], np.asarray(ref_params), atol=1e-4, rtol=1e-3)


def test_state_dict_loads_into_fused_and_unfused(small_net):
    """One set of weights serves both configurations: same keys, same shapes."""
    _, vs, x1, x2 = small_net
    base = load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL), device="cpu"), vs)
    fused = PWCLONet(PWCLONetConfig(**SMALL, fused_eval=True), seed=5, device="cpu")
    assert list(fused.state_dict()) == list(base.state_dict())
    assert len(flatten_variables(vs)) == len(fused.state_dict()) == 429
    fused.load_state_dict(base.state_dict())
    out, ref = _forward(fused, x1, x2), _forward(base, x1, x2)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-4, rtol=1e-3)


def test_fused_net_follows_weights_written_in_place(small_net):
    """No stale fold: after ``load_flax_variables`` overwrites the weights of
    a fused model that has already run, it computes with the new ones."""
    _, vs, x1, x2 = small_net
    seeded = PWCLONet(PWCLONetConfig(**SMALL), seed=2, device="cpu")
    fused = PWCLONet(PWCLONetConfig(**SMALL, fused_eval=True), seed=2, device="cpu")
    before = _forward(fused, x1, x2)[0]  # folds the seeded weights
    np.testing.assert_allclose(before, _forward(seeded, x1, x2)[0], atol=1e-4, rtol=1e-3)
    load_flax_variables(fused, vs)
    after = _forward(fused, x1, x2)[0]
    base = load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL), device="cpu"), vs)
    np.testing.assert_allclose(after, _forward(base, x1, x2)[0], atol=1e-4, rtol=1e-3)
    assert np.abs(after - before).max() > 1e-2


def test_pwclonet_bfloat16_forward(small_net):
    """``compute_dtype="bfloat16"`` runs, fused or not, and gives finite
    float32 poses with unit quaternions near the float32 ones."""
    _, vs, x1, x2 = small_net
    ref = _forward(load_flax_variables(PWCLONet(PWCLONetConfig(**SMALL), device="cpu"), vs), x1, x2)[0]
    for fused in (False, True):
        cfg = PWCLONetConfig(**SMALL, compute_dtype="bfloat16", fused_eval=fused)
        params = _forward(load_flax_variables(PWCLONet(cfg, device="cpu"), vs), x1, x2)[0]
        assert params.dtype == np.float32 and np.isfinite(params).all()
        np.testing.assert_allclose(np.linalg.norm(params[..., 3:], axis=-1), 1.0, atol=1e-5)
        assert 0 < np.abs(params - ref).max() < 0.5


def test_converter_consumes_every_leaf(small_net):
    _, vs, _, _ = small_net
    flat = flatten_variables(vs)
    assert len(flat) == 429
    net = PWCLONet(PWCLONetConfig(**SMALL), device="cpu")
    n_torch = len(dict(net.named_parameters())) + len(dict(net.named_buffers()))
    assert n_torch == 429
    load_flax_variables(net, vs)
    sd = net.state_dict()
    np.testing.assert_array_equal(
        sd["PoseWarpRefinement_2.PoseCalculator_0.LinearHead_2.Dense_0.weight"].numpy(),
        flat["params/PoseWarpRefinement_2/PoseCalculator_0/LinearHead_2/Dense_0/kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["SetConv_4.PointMLP_0.var_2"].numpy(), flat["batch_stats/SetConv_4/PointMLP_0/var_2"]
    )
    assert not hasattr(net.PoseWarpRefinement_2, "FlowPredictor_1")  # last level


def test_converter_raises_on_missing_extra_or_misshapen_leaf(small_net):
    _, vs, _, _ = small_net
    net = PWCLONet(PWCLONetConfig(**SMALL), device="cpu")

    missing = copy.deepcopy(vs)
    del missing["batch_stats"]["CostVolume_0"]["PointMLP_3"]["var_0"]
    with pytest.raises(KeyError, match="left unset"):
        load_flax_variables(net, missing)

    extra = copy.deepcopy(vs)
    extra["params"]["SetConv_0"]["PointMLP_0"]["kernel_9"] = np.zeros((8, 8), np.float32)
    with pytest.raises(KeyError, match="no torch counterpart"):
        load_flax_variables(net, extra)

    misshapen = copy.deepcopy(vs)
    misshapen["params"]["FlowPredictor_0"]["PointMLP_0"]["bias_1"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_variables(net, misshapen)


def test_seeded_init_is_deterministic():
    a = PWCLONet(PWCLONetConfig(**SMALL), seed=3, device="cpu").state_dict()
    b = PWCLONet(PWCLONetConfig(**SMALL), seed=3, device="cpu").state_dict()
    c = PWCLONet(PWCLONetConfig(**SMALL), seed=4, device="cpu").state_dict()
    key = "SetConv_0.PointMLP_0.kernel_0"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
    assert torch.equal(a["SetConv_0.PointMLP_0.scale_0"], torch.ones(8))
    assert torch.equal(a["SetConv_0.PointMLP_0.var_0"], torch.ones(8))


def test_eval_only_and_unported_options_raise():
    """Training is ported: ``train=True`` runs in every configuration and
    leaves the running statistics pending; an unknown compute dtype still
    raises."""
    x = torch.randn(2, 256, 3, generator=torch.Generator().manual_seed(0)) * 8
    for cfg in (PWCLONetConfig(**SMALL), PWCLONetConfig(**SMALL, fused_eval=True),
                PWCLONetConfig(**SMALL, compute_dtype="bfloat16")):
        net = PWCLONet(cfg, device="cpu")
        before = net.SetConv_0.PointMLP_0.mean_0.clone()
        params, _ = net(x, x + 0.01, train=True, bn_momentum=0.5,
                        generator=torch.Generator().manual_seed(1))
        assert params.shape == (2, 4, 7) and params.requires_grad
        assert torch.isfinite(params).all()
        assert torch.equal(net.SetConv_0.PointMLP_0.mean_0, before)
        assert net.SetConv_0.PointMLP_0.pending
    with pytest.raises(ValueError, match="compute_dtype"):
        PWCLONet(PWCLONetConfig(**SMALL, compute_dtype="float16"), device="cpu")
