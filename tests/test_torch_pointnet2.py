"""Port parity: the ball query, the three-NN interpolation and the PointNet++
set modules (``SetConvMSG``, ``FeaturePropagation``, ``LFPModuleMSG``) of
``pwclonet_pylidarslam_torch`` against the JAX reference on the CPU, on the
same numpy inputs and the same weights (``models/convert.py``).

Each module is compared in eval mode (running statistics) and in train
mode: the output, the gradients of a fixed random projection of it with
respect to every parameter and to the input features, and the new running
statistics. Every reference computation is traced once, in a module-scoped
fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch import ops as tops
from pwclonet_pylidarslam_torch.models import load_flax_variables
from pwclonet_pylidarslam_torch.models import pointnet2 as tp2
from pwclonet_pylidarslam_torch.models.convert import flatten_variables, unflatten_variables
from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats
from pwclonet_pylidarslam_torch.ops.knn import pairwise_sqdist
from pwclonet_pylidarslam_tpu import ops as jops
from pwclonet_pylidarslam_tpu.models import pointnet2 as jp2
from pwclonet_pylidarslam_tpu.ops.knn import pairwise_sqdist as j_pairwise_sqdist

# float32 outputs of the same formulas in other reduction orders (XLA fuses
# the products): absolute on unit-scale activations
ATOL, RTOL = 2e-5, 1e-4
# gradients: relative to the largest gradient of the tree
GRAD_RTOL = 1e-4
# a ball-query row may differ only where a distance lies within this many
# ulp of r². The ulp is that of |c|² + |p|², the terms the distance formula
# cancels (its rounding scales with them, not with r²); the two sides'
# distances differ by at most 2 such ulp on these inputs
BOUNDARY_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: with several test workers on one machine, torch's
    thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def T(x):
    return None if x is None else torch.from_numpy(np.array(x))


# ---- ball query --------------------------------------------------------------


def _near_radius(d: np.ndarray, centers: np.ndarray, pts: np.ndarray,
                 radius: float) -> np.ndarray:
    """Rows ``(B, M)`` with a distance within BOUNDARY_ULPS ulp of r², the ulp
    of the distance formula's terms ``|c|² + |p|²`` (float32)."""
    terms = (centers**2).sum(-1)[:, :, None] + (pts**2).sum(-1)[:, None, :]
    ulp = np.spacing(terms.astype(np.float32))
    return (np.abs(d - np.float32(radius * radius)) <= BOUNDARY_ULPS * ulp).any(-1)


def _ball_inputs(case: str):
    r = np.random.default_rng(11)
    pts = r.uniform(-1.0, 1.0, size=(2, 300, 3)).astype(np.float32)
    centers = np.concatenate([
        pts[:, :24],  # centres on points of the cloud, as FPS gives them
        r.uniform(-1.0, 1.0, size=(2, 16, 3)).astype(np.float32),
        r.uniform(2.0, 3.0, size=(2, 8, 3)).astype(np.float32),  # no hit
    ], axis=1)
    if case == "shell":
        # a third of the cloud on spheres of the radius around the centres:
        # distances at r² to within rounding, where the two sides' sums may
        # round to either side
        u = r.normal(size=(2, 100, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        pts[:, :100] = (centers[:, r.integers(0, 40, 100)] + 0.4 * u).astype(np.float32)
    mask = (r.random((2, 300)) > 0.3).astype(np.float32) if case == "masked" else None
    return centers, pts, mask


@pytest.mark.parametrize("case", ["plain", "masked", "shell"])
def test_ball_query_matches_reference(case):
    centers, pts, mask = _ball_inputs(case)
    radius, nsample = 0.4, 8
    ref = np.asarray(jops.ball_query(jnp.asarray(centers), jnp.asarray(pts), radius, nsample,
                                     None if mask is None else jnp.asarray(mask)))
    out = tops.ball_query(T(centers), T(pts), radius, nsample, T(mask)).numpy()
    assert out.dtype == np.int32 and out.shape == (2, 48, nsample)
    d = pairwise_sqdist(T(centers), T(pts)).numpy()
    valid = np.ones((2, 1, 300), bool) if mask is None else mask[:, None, :] > 0
    hits = ((d < np.float32(radius * radius)) & valid).sum(-1)
    # the input has rows of every kind: none, fewer than nsample, full
    assert (hits == 0).any() and ((hits > 0) & (hits < nsample)).any() and (hits >= nsample).any()
    np.testing.assert_array_equal(out[hits == 0], 0)
    differ = (out != ref).any(-1)
    d_ref = np.asarray(j_pairwise_sqdist(jnp.asarray(centers), jnp.asarray(pts)))
    boundary = (_near_radius(d, centers, pts, radius)
                | _near_radius(d_ref, centers, pts, radius))
    assert not (differ & ~boundary).any(), f"rows {np.argwhere(differ & ~boundary)} differ"
    if case == "shell":
        assert differ.any()  # the rule is exercised


# ---- three-NN interpolation --------------------------------------------------


@pytest.fixture(scope="module")
def interp_inputs():
    r = np.random.default_rng(5)
    known = r.uniform(-1.0, 1.0, size=(2, 40, 3)).astype(np.float32)
    # a fifth of the unknown points coincide with known ones, as FPS centres
    # coincide with points of the finer cloud
    unknown = np.concatenate([r.uniform(-1.0, 1.0, size=(2, 80, 3)).astype(np.float32),
                              known[:, :20]], axis=1)
    feats = r.normal(size=(2, 40, 5)).astype(np.float32)
    return unknown, known, feats


def test_three_nn_matches_reference(interp_inputs):
    unknown, known, _ = interp_inputs
    jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = tops.three_nn(T(unknown), T(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # the reference's fused cross term: ~1e-7 on unit-scale points; the
    # port's distance to a coincident point is exactly 0
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    assert np.all(d.numpy()[:, 80:, 0] == 0.0)


def test_three_interpolate_and_its_gradient_match_reference(interp_inputs):
    unknown, known, feats = interp_inputs
    jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    w = np.random.default_rng(6).normal(size=(2, 100, 5)).astype(np.float32)

    def jloss(f, d, i):
        return jnp.sum(jops.three_interpolate(f, i, d) * w)

    jout = np.asarray(jops.three_interpolate(jnp.asarray(feats), ji, jd))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(feats), jd, ji))
    # the same neighbours and distances: the same weights to rounding
    f = T(feats).requires_grad_(True)
    out = tops.three_interpolate(f, T(ji), T(jd))
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-6, rtol=1e-6)
    (g,) = torch.autograd.grad(torch.sum(out * T(w)), f)
    np.testing.assert_allclose(g.numpy(), jgrad, atol=1e-5, rtol=1e-5)
    # the port's own neighbours: at a coincident point its weight is 1 - ~1e-6
    # (d = 0) against the reference's 1 - ~1e-5 (d ~ 1e-7), so rows move by
    # ~1e-5 of the features' scale (unit here)
    d, i = tops.three_nn(T(unknown), T(known))
    np.testing.assert_allclose(tops.three_interpolate(T(feats), i, d).numpy(), jout,
                               atol=1e-4, rtol=0)


# ---- the set modules ---------------------------------------------------------


def _cloud(seed: int, n: int, c: int = 0):
    r = np.random.default_rng(seed)
    xyz = r.uniform(-1.0, 1.0, size=(2, n, 3)).astype(np.float32)
    feat = r.normal(size=(2, n, c)).astype(np.float32) if c else None
    return xyz, feat


def _stats(variables, rng):
    """Running statistics away from their initial values, so that eval mode
    reads them."""
    return {k: (np.asarray(v) + np.abs(rng.normal(size=np.shape(v))) * 0.3).astype(np.float32)
            for k, v in flatten_variables(variables["batch_stats"]).items()}


# name -> (Flax module, port module, positional inputs as numpy)
def _cases():
    xyz, feat = _cloud(1, 96, 5)
    xyz2, feat2 = _cloud(2, 24, 4)
    j_msg = jp2.SetConvMSG(npoint=24, radii=(0.4, 0.8), nsamples=(8, 16),
                           mlps=((8, 16), (8, 12)))
    t_msg = tp2.SetConvMSG(5, 24, (0.4, 0.8), (8, 16), ((8, 16), (8, 12)))
    j_all = jp2.SetConvMSG(npoint=None, radii=(None,), nsamples=(None,), mlps=((8, 16),))
    t_all = tp2.SetConvMSG(5, None, (None,), (None,), ((8, 16),))
    j_fp = jp2.FeaturePropagation((16, 8))
    t_fp = tp2.FeaturePropagation(4, 5, (16, 8))
    j_lfp = jp2.LFPModuleMSG(radii=(0.4, 0.8), nsamples=(4, 8), mlps=((8, 12), (8, 12)),
                             post_mlp=(10,))
    t_lfp = tp2.LFPModuleMSG(5, 4, (0.4, 0.8), (4, 8), ((8, 12), (8, 12)), (10,))
    glob = feat2[:, :1]
    return {
        "SetConvMSG": (j_msg, t_msg, (xyz, feat)),
        "SetConvMSG group-all": (j_all, t_all, (xyz, feat)),
        "FeaturePropagation": (j_fp, t_fp, (xyz, xyz2, feat, feat2)),
        "FeaturePropagation known=None": (j_fp, t_fp, (xyz, None, feat, glob)),
        "LFPModuleMSG": (j_lfp, t_lfp, (xyz2, xyz, feat2, feat)),
    }


CASES = list(_cases())


def _feature_arg(name: str) -> int:
    """Position of the input features the gradient is taken for."""
    return 1 if name.startswith("SetConvMSG") else 3


def _outputs(out):
    return out[1] if isinstance(out, tuple) else out  # SetConvMSG: (new_xyz, features)


@pytest.fixture(scope="module")
def reference():
    """Per case: the variables, the eval output, and the train-mode output,
    new statistics and gradients (params, input features) of
    ``sum(out * w)``."""
    results = {}
    for seed, (name, (jmod, _tmod, args)) in enumerate(_cases().items()):
        rng = np.random.default_rng(seed)
        jargs = [None if a is None else jnp.asarray(a) for a in args]
        variables = _f32(jmod.init(jax.random.key(0), *jargs, train=False))
        params = jax.tree.map(np.asarray, variables["params"])
        stats = _stats(variables, rng)
        variables = {"params": params, "batch_stats": unflatten_variables(stats)}
        eval_out = _outputs(jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
            variables, *jargs))
        w = rng.normal(size=eval_out.shape).astype(np.float32)
        k = _feature_arg(name)

        def loss_fn(p, x, *a):
            a = list(a)
            a[k] = x
            out, mutated = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                      *a, train=True, bn_momentum=0.5, mutable=["batch_stats"])
            out = _outputs(out)
            return jnp.sum(out * w), (out, mutated["batch_stats"])

        (_, (train_out, new_stats)), (gp, gx) = jax.jit(
            jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
                params, jargs[k], *jargs)
        results[name] = {
            "variables": variables, "w": w, "eval": np.asarray(eval_out),
            "train": np.asarray(train_out), "new_stats": flatten_variables(new_stats),
            "grad_params": flatten_variables({"params": jax.tree.map(np.asarray, gp)}),
            "grad_x": np.asarray(gx),
        }
    return results


def _port(name: str, reference):
    _jmod, tmod, args = _cases()[name]
    return load_flax_variables(tmod, reference[name]["variables"]), [T(a) for a in args]


@pytest.mark.parametrize("name", CASES)
def test_module_eval_matches_reference(reference, name):
    tmod, args = _port(name, reference)
    with torch.no_grad():
        out = _outputs(tmod(*args, train=False))
    np.testing.assert_allclose(out.numpy(), reference[name]["eval"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASES)
def test_module_train_matches_reference(reference, name):
    ref = reference[name]
    tmod, args = _port(name, reference)
    k = _feature_arg(name)
    args[k] = args[k].clone().requires_grad_(True)
    out = _outputs(tmod(*args, train=True, bn_momentum=0.5))
    np.testing.assert_allclose(out.detach().numpy(), ref["train"], atol=ATOL, rtol=RTOL)
    named = dict(tmod.named_parameters())
    grads = torch.autograd.grad(torch.sum(out * T(ref["w"])), [*named.values(), args[k]])
    scale = max(np.abs(g).max() for g in ref["grad_params"].values())
    for (key, _), g in zip(named.items(), grads):
        flax_path = "params/" + key.replace(".", "/")
        np.testing.assert_allclose(g.numpy(), ref["grad_params"][flax_path],
                                   atol=GRAD_RTOL * scale, rtol=0, err_msg=key)
    np.testing.assert_allclose(grads[-1].numpy(), ref["grad_x"],
                               atol=GRAD_RTOL * np.abs(ref["grad_x"]).max(), rtol=0)
    # the new running statistics wait for the commit, then land in the buffers
    commit_batch_stats(tmod)
    buffers = dict(tmod.named_buffers())
    for path, new in ref["new_stats"].items():
        np.testing.assert_allclose(buffers[path.replace("/", ".")].numpy(), new,
                                   atol=1e-5, rtol=5e-6, err_msg=path)


def test_lfp_post_mlp_is_flax_pointmlp_0(reference):
    """The shared post MLP is the first PointMLP Flax builds."""
    params = reference["LFPModuleMSG"]["variables"]["params"]
    assert params["PointMLP_0"]["kernel_0"].shape == (12 + 4, 10)
    assert params["PointMLP_1"]["kernel_0"].shape == (3 + 5, 8)
