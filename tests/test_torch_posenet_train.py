"""PoseNet training of the port against the JAX reference on the CPU: one
Adam and one AdamW step from a converted reference train state (loss,
gradients, running statistics, updates), the learning-rate schedule across
its milestones, the skipped non-finite step, the unsupervised step, the
trainer with its checkpoints driving ``PoseNetOdometry``, and the scoped
precision of the step. The same float32 numpy inputs go through both, at
16×64 vertex maps; train states cross through ``tools/export_flax_checkpoint.py``
and ``models/convert.py::load_flax_train_state``.

Tolerances, and why:
- the loss to 1e-5 relative; every gradient leaf to 1e-5 + 1e-3 of its
  largest magnitude (~20 convolutions and their backward summed in another
  order); running statistics to 1e-5 + 1e-4 relative;
- the parameter updates of the second step (Adam's moments carried
  across) where |g| > 1e-4: 99.99 % of them to 5e-3 of the learning rate
  and all to 5e-2. The update is a function of g/|g| and of the first
  step's moments, so its error follows the gradients' relative error, which
  grows where g is small or cancels the first moment (test_torch_train.py
  compares a first step likewise);
- the learning rate equal in float32.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pwclonet_pylidarslam_torch.core.projection import SphericalProjector as TProj
from pwclonet_pylidarslam_torch.data import vm_pairs as tvm
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.models import load_flax_train_state
from pwclonet_pylidarslam_torch.models import posenet as tpn
from pwclonet_pylidarslam_torch.models.convert import _torch_key, _trainable_key, flatten_variables
from pwclonet_pylidarslam_torch.models.layers import discard_batch_stats
from pwclonet_pylidarslam_torch.slam import deep_odometry as tdo
from pwclonet_pylidarslam_torch.train import posenet_state as tps
from pwclonet_pylidarslam_torch.train.posenet_trainer import PoseNetTrainer, PoseNetTrainerConfig
from pwclonet_pylidarslam_tpu.core.projection import SphericalProjector as JProj
from pwclonet_pylidarslam_tpu.data import vm_pairs as jvm
from pwclonet_pylidarslam_tpu.train import posenet_state as jps
from tools.export_flax_checkpoint import train_state_to_tree

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


def test_schedule_across_milestones():
    cfg_j = jps.PoseNetTrainConfig(lr_milestones=(10, 20), lr_gamma=0.5, learning_rate=1e-3)
    cfg_t = tps.PoseNetTrainConfig(lr_milestones=(10, 20), lr_gamma=0.5, learning_rate=1e-3)
    ref = jps.make_lr_schedule(cfg_j)
    for count in (0, 9, 10, 11, 19, 20, 25):
        got = float(tps.learning_rate(cfg_t, count))
        assert np.float32(got) == np.float32(ref(count)), count
    assert float(tps.learning_rate(cfg_t, torch.tensor(25))) == 2.5e-4


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_train_step_from_a_converted_reference_state(vm_batch, weight_decay):
    """One reference step, the state carried across, then a second step on
    each side: loss, gradients, running statistics, moments and updates."""
    proj = JProj(height=H, width=W)
    cfg_j = jps.PoseNetTrainConfig(projector=proj, learning_rate=1e-3, weight_decay=weight_decay)
    cfg_t = tps.PoseNetTrainConfig(projector=TProj(height=H, width=W), learning_rate=1e-3,
                                   weight_decay=weight_decay)
    model, st0 = jps.create_posenet_train_state(cfg_j, jax.random.key(0), (H, W))
    batch = {k: jnp.asarray(v) for k, v in vm_batch.items()}
    step = jax.jit(lambda s, b: jps.posenet_train_step(model, cfg_j, s, b, jax.random.key(1)))
    st1, _ = step(st0, batch)
    tree1 = train_state_to_tree(st1)

    # the reference's gradients of the second step
    def loss_fn(trainable):
        pred, mutated = model.apply(
            {"params": trainable["net"], "batch_stats": st1.batch_stats},
            jnp.stack([batch["vm1"], batch["vm2"]], axis=1), train=True, mutable=["batch_stats"])
        loss, _ = jps._loss_and_log(cfg_j, trainable["loss"], pred, batch)
        return loss, mutated["batch_stats"]

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {"net": st1.params, "loss": st1.loss_params})
    st2, ref_log = step(st1, batch)

    port = tps.create_posenet_train_state(cfg_t, device="cpu")
    load_flax_train_state(port, tree1)
    assert port.step == 1 and int(port.optimizer.count) == 1
    before = {k: v.detach().clone() for k, v in port.trainable().items()}
    loss, _, grads = tps.posenet_loss_and_grads(cfg_t, port, vm_batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    flat = flatten_variables(to_numpy(ref_grads))
    assert len(flat) == len(grads)
    for path, want in flat.items():
        key, perm = _trainable_key(path)
        want = want if perm is None else want.transpose(perm)
        np.testing.assert_allclose(N(grads[key]), want, rtol=0,
                                   atol=1e-5 + 1e-3 * np.abs(want).max(), err_msg=key)
    discard_batch_stats(port.model)
    log = tps.posenet_train_step(cfg_t, port, vm_batch)
    np.testing.assert_allclose(float(log["loss"]), float(ref_log["loss"]), rtol=1e-5)
    assert port.step == 2 and int(port.optimizer.count) == 2 and not bool(log["skipped_nonfinite"])
    after = port.trainable()
    new = {"net": to_numpy(st2.params), "loss": to_numpy(st2.loss_params)}
    old = {"net": tree1["params"], "loss": tree1["loss_params"]}
    gaps = []
    for path, want in flatten_variables(new).items():
        key, perm = _trainable_key(path)
        fix = (lambda a: a) if perm is None else (lambda a: a.transpose(perm))
        mask = np.abs(fix(flat[path])) > 1e-4
        ref_update = fix(want) - fix(flatten_variables(old)[path])
        gaps.append(np.abs(N(after[key] - before[key]) - ref_update)[mask])
    gaps = np.concatenate(gaps) / cfg_t.learning_rate
    assert gaps.size > 100_000
    assert np.mean(gaps <= 5e-3) >= 0.9999 and gaps.max() <= 5e-2, np.sort(gaps)[-5:]
    buffers = dict(port.model.named_buffers())
    for path, want in flatten_variables({"batch_stats": to_numpy(ref_stats)}).items():
        key, _ = _torch_key(path)
        np.testing.assert_allclose(N(buffers[key]), want, atol=1e-5, rtol=1e-4, err_msg=key)


def test_nonfinite_step_changes_nothing_and_unsupervised_step_runs(vm_batch):
    proj = TProj(height=H, width=W)
    state = tps.create_posenet_train_state(tps.PoseNetTrainConfig(projector=proj), device="cpu")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    bad = dict(vm_batch, gt_pose=np.full_like(vm_batch["gt_pose"], np.nan))
    log = tps.posenet_train_step(tps.PoseNetTrainConfig(projector=proj), state, bad)
    assert bool(log["skipped_nonfinite"]) and state.step == 1
    assert int(state.optimizer.count) == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    cfg = tps.PoseNetTrainConfig(loss="unsupervised", projector=proj)
    state = tps.create_posenet_train_state(cfg, device="cpu")
    assert state.loss_params == {}
    batch = {k: v for k, v in vm_batch.items() if k != "gt_pose"}
    log = tps.posenet_train_step(cfg, state, batch)
    assert np.isfinite(float(log["loss"])) and float(log["grad_norm"]) > 0
    pred, log = tps.posenet_eval_step(cfg, state, batch)
    assert pred.shape == (2, 1, 6) and np.isfinite(float(log["loss"]))
    with pytest.raises(ValueError, match="num_out_poses"):
        tps.create_posenet_train_state(tps.PoseNetTrainConfig(
            model=tpn.PoseResNetConfig(sequence_len=3, num_out_poses=1)), device="cpu")


def test_trainer_fits_checkpoints_and_drives_the_odometry(tmp_path, scans):
    s, gt = scans
    proj = TProj(height=H, width=W)
    cfg = PoseNetTrainerConfig(train=tps.PoseNetTrainConfig(projector=proj, learning_rate=1e-3),
                               vm_shape=(H, W), num_epochs=2, log_dir=str(tmp_path),
                               steps_per_dispatch=2)
    trainer = PoseNetTrainer(cfg, device="cpu")
    ds = tvm.VertexMapPairDataset.from_scans(s, gt, proj, num_points=2048, device="cpu")
    history = trainer.fit(lambda: ds.batches(2, seed=trainer.epoch),
                          lambda: ds.batches(2, shuffle=False))
    assert len(history) == 2 and np.isfinite(history[-1]["train_loss"])
    assert np.isfinite(history[-1]["ATE"])
    assert trainer.state.step == 4 and trainer.checkpoint_steps()[-1] == 4
    again = PoseNetTrainer(cfg, device="cpu")
    again.load_checkpoint()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    odo = tdo.PoseNetOdometry(again.odometry_variables(), tdo.PoseNetOdometryConfig(projector=proj),
                              device="cpu")
    odo.init()
    poses = odo.process_sequence(s)
    assert poses.shape == (6, 4, 4) and np.all(np.isfinite(poses))
    path = again.checkpoint_path(4)
    from_path = tdo.PoseNetOdometry(path, tdo.PoseNetOdometryConfig(projector=proj), device="cpu")
    from_path.init()
    np.testing.assert_array_equal(from_path.process_sequence(s), poses)


def test_train_step_sets_fp32_deterministic_convolutions_and_restores(vm_batch):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    seen = []
    orig = tpn.Conv.forward

    def spy(self, x):
        seen.append((matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark))
        return orig(self, x)

    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = cudnn.benchmark = True
        cudnn.deterministic = False
        tpn.Conv.forward = spy
        cfg = tps.PoseNetTrainConfig(projector=TProj(height=H, width=W))
        tps.posenet_train_step(cfg, tps.create_posenet_train_state(cfg, device="cpu"), vm_batch)
        assert seen and all(s == (False, False, True, False) for s in seen)
        assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark) == (
            True, True, False, True)
    finally:
        tpn.Conv.forward = orig
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved
