"""PoseNet of the port against the JAX reference on the CPU: PoseResNet
(ResNet-18, 34 and 50, eval and train mode, the running statistics of one
train forward, gelu), both losses and their gradients, the vertex-map
datasets and ``PoseNetOdometry`` (the training steps:
``test_torch_posenet_train.py``). The same float32
numpy inputs, made from a seed, go through both at 16×64 vertex maps (even,
so Flax's uneven SAME padding at stride 2 is exercised); Flax variables
and train states cross through ``models/convert.py``.

Tolerances, and why:
- pose params to 1e-5 + 1e-4 relative: ~20-50 convolutions summed in
  another order (oneDNN against XLA); in train mode the batch statistics
  of a 16×64 batch of two are ill-conditioned, so the port is held in
  float64 to the reference in float64 (1e-9, outputs and running
  statistics) and in float32 to no further from that than twice the
  reference's own float32 error;
- losses to 1e-5 relative, their gradients in ``pred_params`` to 1e-5 +
  1e-4 of the largest;
- vertex maps bit-equal; dataset items and batches equal;
- odometry poses to 1e-5 (per frame against the batched forward, and
  against the reference).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.core import se3 as tse3
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector as TProj
from pwclonet_pylidarslam_torch.data import vm_pairs as tvm
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.models import load_flax_variables
from pwclonet_pylidarslam_torch.models import posenet as tpn
from pwclonet_pylidarslam_torch.models.convert import _torch_key, flatten_variables
from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats, discard_batch_stats
from pwclonet_pylidarslam_torch.slam import deep_odometry as tdo
from pwclonet_pylidarslam_torch.train import posenet_losses as tpl
from pwclonet_pylidarslam_torch.train import posenet_state as tps
from pwclonet_pylidarslam_tpu.core import se3 as jse3
from pwclonet_pylidarslam_tpu.core.projection import SphericalProjector as JProj
from pwclonet_pylidarslam_tpu.data import vm_pairs as jvm
from pwclonet_pylidarslam_tpu.models import posenet as jpn
from pwclonet_pylidarslam_tpu.slam import deep_odometry as jdo
from pwclonet_pylidarslam_tpu.train import posenet_losses as jpl

H, W = 16, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This file's many small tensor ops run on one thread: with several test
    workers on one machine, torch's thread pool per worker oversubscribes
    the cores and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def scans():
    return generate_sequence(SyntheticSequenceConfig(n_frames=6, num_points=2048, seed=1))


@pytest.fixture(scope="module")
def vm_batch(scans):
    """Two pairs of 16×64 vertex maps with their ground truth."""
    s, gt = scans
    ds = jvm.VertexMapPairDataset.from_scans(s[:3], gt[:3], JProj(height=H, width=W),
                                             num_points=2048)
    return next(ds.batches(2, shuffle=False))


def _frames(rng, b=2, seq=2):
    """Vertex-map-like inputs: ranges of a few to tens of meters, a few
    empty pixels."""
    x = (rng.normal(size=(b, seq, H, W, 3)) * 10.0).astype(np.float32)
    x[rng.uniform(size=x.shape[:-1]) < 0.1] = 0.0
    return x


def _pair(cfg: jpn.PoseResNetConfig):
    """A seeded reference model and the port loaded with its variables."""
    model = jpn.PoseResNet(cfg)
    variables = model.init(jax.random.key(0), jnp.zeros((1, cfg.sequence_len, H, W, 3)),
                           train=False)
    port = tpn.PoseResNet(tpn.PoseResNetConfig(**vars(cfg)), device="cpu")
    load_flax_variables(port, to_numpy(variables))
    return model, variables, port


def _assert_params(got, want):
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5, rtol=1e-4)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


@pytest.mark.parametrize("resnet", [18, 34, 50])
def test_forward_eval_and_train_match_reference(rng, resnet):
    cfg = jpn.PoseResNetConfig(resnet_model=resnet)
    model, variables, port = _pair(cfg)
    x = _frames(rng)
    # perturbed running statistics, so eval mode reads them
    stats = jax.tree.map(lambda v: np.asarray(v) * np.float32(1.3) + np.float32(0.05),
                         variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    load_flax_variables(port, to_numpy(variables))
    _assert_params(port(T(x)), jax.jit(lambda v, f: model.apply(v, f))(variables, jnp.asarray(x)))

    # train mode normalises with the batch's statistics, E[x²] − E[x]² over
    # as few as 4 values a channel in the last stage: the reference's own
    # float32 result lies up to 8e-4 from its float64 one (ResNet-50). The
    # port in float64 is held to the reference in float64 (1e-9), and in
    # float32 to no further from it than twice the reference's float32
    train = jax.jit(lambda v, f: model.apply(v, f, train=True, mutable=["batch_stats"]))
    ref32, _ = train(variables, jnp.asarray(x))
    ref64, mutated = train(_f64(variables), jnp.asarray(x, jnp.float64))
    got32 = N(port(T(x), train=True))
    ref_err = np.abs(np.asarray(ref32) - np.asarray(ref64)).max()
    assert np.abs(got32 - np.asarray(ref64)).max() <= 2.0 * ref_err + 1e-5, ref_err
    discard_batch_stats(port)
    port = port.double()
    got64 = port(T(x).double(), train=True)
    np.testing.assert_allclose(N(got64), np.asarray(ref64), atol=1e-9)
    commit_batch_stats(port)
    buffers = dict(port.named_buffers())
    ref_stats = flatten_variables({"batch_stats": to_numpy(mutated["batch_stats"])})
    assert len(ref_stats) == len(buffers)
    for path, value in ref_stats.items():
        key, _ = _torch_key(path)
        np.testing.assert_allclose(N(buffers[key]), value, atol=1e-9, rtol=1e-9, err_msg=key)


def test_gelu_and_window_forward_match_reference(rng):
    """gelu (Flax's tanh approximation) and a 3-frame window regressing two
    poses."""
    for cfg in (jpn.PoseResNetConfig(activation="gelu"),
                jpn.PoseResNetConfig(sequence_len=3, num_out_poses=2, activation="softplus")):
        model, variables, port = _pair(cfg)
        x = _frames(rng, seq=cfg.sequence_len)
        got = port(T(x))
        assert got.shape == (2, cfg.num_out_poses, 6)
        _assert_params(got, jax.jit(lambda v, f: model.apply(v, f))(variables, jnp.asarray(x)))


def test_same_padding_is_flax_s():
    # stride 2 over even sizes pads 0 before and 1 after (3x3), 2/3 (7x7)
    assert tpn.same_pads((16, 64), (3, 3), (2, 2)) == (0, 1, 0, 1)
    assert tpn.same_pads((16, 64), (7, 7), (2, 2)) == (2, 3, 2, 3)
    assert tpn.same_pads((15, 63), (3, 3), (2, 2)) == (1, 1, 1, 1)
    assert tpn.same_pads((16, 64), (1, 1), (2, 2)) == (0, 0, 0, 0)
    assert tpn.same_pads((16, 64), (3, 3), (1, 1)) == (1, 1, 1, 1)


@pytest.mark.parametrize("option,weights", [("l1", True), ("l2", False)])
def test_supervised_loss_and_gradients_match_reference(rng, option, weights):
    gt = np.asarray(jse3.exp(jnp.asarray((rng.normal(size=(4, 6)) * 0.1).astype(np.float32))))
    pred = (np.asarray(jse3.pose_to_params_euler(jnp.asarray(gt)))
            + rng.normal(size=(4, 6)).astype(np.float32) * 0.05).astype(np.float32)
    jcfg = jpl.SupervisedLossConfig(loss_option=option, with_exp_weights=weights)
    tcfg = tpl.SupervisedLossConfig(loss_option=option, with_exp_weights=weights)
    jparams = jpl.init_supervised_loss_params(jcfg)

    def ref_loss(p):
        return jpl.pose_supervision_loss(jparams, p, jnp.asarray(gt), jcfg)[0]

    ref, ref_log = jpl.pose_supervision_loss(jparams, jnp.asarray(pred), jnp.asarray(gt), jcfg)
    ref_grad = np.asarray(jax.grad(ref_loss)(jnp.asarray(pred)))
    p = T(pred).requires_grad_()
    loss, log = tpl.pose_supervision_loss(tpl.init_supervised_loss_params(tcfg), p, T(gt), tcfg)
    (grad,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    assert set(log) == set(ref_log)
    for key in log:
        np.testing.assert_allclose(N(log[key]), np.asarray(ref_log[key]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(N(grad), ref_grad, atol=1e-5 + 1e-4 * np.abs(ref_grad).max())
    # at the ground truth both residual terms vanish
    _, zero = tpl.pose_supervision_loss({}, tse3.pose_to_params_euler(T(gt)), T(gt),
                                        tpl.SupervisedLossConfig(with_exp_weights=False))
    assert float(zero["loss_rot"]) < 1e-4 and float(zero["loss_trans"]) < 1e-6


def test_point_to_plane_loss_and_gradients_match_reference(vm_batch):
    proj_j, proj_t = JProj(height=H, width=W), TProj(height=H, width=W)
    pred = np.array([[0.3, -0.1, 0.02, 0.01, -0.02, 0.03],
                     [0.0, 0.2, 0.0, 0.0, 0.01, -0.02]], np.float32)
    tgt, ref_vm = vm_batch["vm1"], vm_batch["vm2"]

    def ref_loss(p):
        return jpl.point_to_plane_loss(proj_j, jnp.asarray(tgt), jnp.asarray(ref_vm), p)

    want, want_grad = jax.jit(jax.value_and_grad(ref_loss))(jnp.asarray(pred))
    want, want_grad = float(want), np.asarray(want_grad)
    p = T(pred).requires_grad_()
    loss = tpl.point_to_plane_loss(proj_t, T(tgt), T(ref_vm), p)
    (grad,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(N(grad), want_grad, atol=1e-5 + 1e-4 * np.abs(want_grad).max())


def test_vm_datasets_match_reference(scans):
    s, gt = scans
    proj_j, proj_t = JProj(height=H, width=W), TProj(height=H, width=W)
    # uneven scan sizes, a crop, and a tail chunk padded to one shape
    ragged = [s[0][:1500], s[1], s[2][:900], s[3], s[4]]
    vm_j = jvm.project_scans(ragged, proj_j, num_points=1024, chunk=2)
    vm_t = tvm.project_scans(ragged, proj_t, num_points=1024, chunk=2, device="cpu")
    assert vm_t.shape == (5, H, W, 3)
    np.testing.assert_array_equal(vm_t, vm_j)
    pair_j = jvm.VertexMapPairDataset(vm_j, gt[:5])
    pair_t = tvm.VertexMapPairDataset(vm_t, gt[:5])
    win_j = jvm.VertexMapWindowDataset(vm_j, gt[:5], sequence_len=3, stride=1)
    win_t = tvm.VertexMapWindowDataset(vm_t, gt[:5], sequence_len=3, stride=1)
    strided_j = jvm.VertexMapWindowDataset(vm_j, None, sequence_len=2, stride=2)
    strided_t = tvm.VertexMapWindowDataset(vm_t, None, sequence_len=2, stride=2)
    back_j = jvm.VertexMapWindowDataset(vm_j[::-1].copy(), gt[:5][::-1].copy(), sequence_len=3)
    back_t = tvm.VertexMapWindowDataset(vm_t[::-1].copy(), gt[:5][::-1].copy(), sequence_len=3)
    multi_j = [jvm.concat_pair_datasets([pair_j, pair_j]),
               jvm.MultiSequenceWindowDataset([win_j, back_j])]
    multi_t = [tvm.concat_pair_datasets([pair_t, pair_t]),
               tvm.MultiSequenceWindowDataset([win_t, back_t])]
    for a, b in zip([pair_j, win_j, strided_j] + multi_j, [pair_t, win_t, strided_t] + multi_t):
        assert len(a) == len(b)
        for seed in (0, 3):
            got, want = list(b.batches(2, seed=seed)), list(a.batches(2, seed=seed))
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert set(x) == set(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    with pytest.raises(IndexError):
        multi_t[0][len(multi_t[0])]


def test_odometry_per_frame_matches_batched_and_reference(scans):
    s, _ = scans
    jcfg = jdo.PoseNetOdometryConfig(projector=JProj(height=H, width=W))
    model = jpn.PoseResNet(jcfg.model)
    variables = model.init(jax.random.key(3), jnp.zeros((1, 2, H, W, 3)), train=False)
    ref = jdo.PoseNetOdometry(variables, jcfg)
    ref.init()
    for scan in s[:5]:
        ref.process_next_frame(scan)
    tcfg = tdo.PoseNetOdometryConfig(projector=TProj(height=H, width=W))
    a = tdo.PoseNetOdometry(to_numpy(variables), tcfg, device="cpu")
    a.init()
    for scan in s[:5]:
        a.process_next_frame(scan)
    np.testing.assert_allclose(a.absolute_poses(), ref.absolute_poses(), atol=1e-5)
    b = tdo.PoseNetOdometry(to_numpy(variables), tcfg, device="cpu")
    b.init()
    out = np.concatenate([b.process_sequence(s[:2]), b.process_sequence(s[2:5])])
    assert out.shape == (5, 4, 4)
    np.testing.assert_allclose(b.absolute_poses(), a.absolute_poses(), atol=1e-5)
    np.testing.assert_allclose(b.relative_poses(), a.relative_poses(), atol=1e-5)
    np.testing.assert_array_equal(a.absolute_poses()[0], np.eye(4))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdo.PoseNetOdometry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tps.create_posenet_train_state(tps.PoseNetTrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tvm.project_scans([np.ones((4, 3), np.float32)], TProj())


