"""The siamese pyramid of the port's ``PWCLONet`` samples and groups both
frames in one launch of each point op, stacked on the batch axis. Held here,
on the CPU and to the bit, against the pyramid that runs each ``SetConv`` on
one frame after the other (as the reference's network does): FPS, kNN and
gather work on every sample on its own, and the MLP still runs once per
frame, so nothing may change, in eval mode or in train mode."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig
from pwclonet_pylidarslam_torch.models.layers import PointMLP
from pwclonet_pylidarslam_torch.models.pointnet2 import SetConv
from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.train import state as tstate

SMALL = PWCLONetConfig(num_points=256, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))


def per_frame_pyramid(self, xyz1, xyz2, train=False, bn_momentum=0.1):
    """The reference function: each level's ``SetConv`` on frame 1, then on
    frame 2, every op at the batch size of one frame."""
    kw = dict(train=train, bn_momentum=bn_momentum)
    f1, f2 = [(xyz1, None)], [(xyz2, None)]
    for level in range(4):
        sa = getattr(self, f"SetConv_{level}")
        f1.append(sa(*f1[-1], **kw))
        f2.append(sa(*f2[-1], **kw))
    return f1[1:], f2[1:]


def _per_frame(model: PWCLONet) -> PWCLONet:
    model.pyramid = types.MethodType(per_frame_pyramid, model)
    return model


def _clouds(seed: int, b: int = 2, n: int = 256):
    rng = np.random.default_rng(seed)
    xyz2 = (rng.normal(size=(b, n, 3)) * [8.0, 8.0, 1.5]).astype(np.float32)
    xyz2[:, :3] = 0.0  # padding rows: FPS must skip them in both frames
    xyz1 = (xyz2 + rng.normal(size=(b, n, 3)) * 0.05 + [0.4, 0.0, 0.0]).astype(np.float32)
    xyz1 = xyz1[:, rng.permutation(n)]
    return xyz1, xyz2


def _perturb_stats(model: PWCLONet, seed: int) -> None:
    """Running statistics away from (0, 1), so that BatchNorm matters."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            noise = torch.from_numpy(rng.normal(size=tuple(buf.shape)).astype(np.float32)) * 0.2
            buf.add_(noise.abs() if name.rsplit(".", 1)[-1].startswith("var") else noise)


@pytest.mark.parametrize("fused_eval", [False, True])
def test_eval_forward_equals_the_per_frame_pyramid_to_the_bit(fused_eval):
    cfg = dataclasses.replace(SMALL, fused_eval=fused_eval)
    paired = PWCLONet(cfg, seed=3, device="cpu")
    _perturb_stats(paired, 0)
    split = _per_frame(PWCLONet(cfg, seed=4, device="cpu"))
    split.load_state_dict(paired.state_dict())
    xyz1, xyz2 = (torch.from_numpy(a) for a in _clouds(0))
    with torch.inference_mode():
        out, aux = paired(xyz1, xyz2)
        ref, ref_aux = split(xyz1, xyz2)
    assert out.shape == (2, 4, 7) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref)
    assert torch.equal(aux["embedding_mask"], ref_aux["embedding_mask"])
    assert torch.equal(aux["point_cloud"], ref_aux["point_cloud"])


def test_pyramid_levels_equal_the_per_frame_pyramid_to_the_bit():
    model = PWCLONet(SMALL, seed=5, device="cpu")
    _perturb_stats(model, 1)
    xyz1, xyz2 = (torch.from_numpy(a) for a in _clouds(1, b=3))
    with torch.inference_mode():
        f1, f2 = model.pyramid(xyz1, xyz2)
        r1, r2 = per_frame_pyramid(model, xyz1, xyz2)
    for got, want in zip(f1 + f2, r1 + r2):
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _train_pass(state, cfg, batch):
    loss, _, grads = tstate.loss_and_grads(cfg, state, batch)
    pending = {f"{name}.{key}": value.clone()
               for name, m in state.model.named_modules() if isinstance(m, PointMLP)
               for key, value in m.pending.items()}
    return loss, grads, pending


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_train_step_equals_the_per_frame_pyramid_to_the_bit(dropout):
    """Loss, every gradient leaf and every pending running statistic; with
    dropout on, both runs draw their masks from generators in the same state."""
    cfg = tstate.TrainConfig(model=SMALL, total_steps=100)
    paired = tstate.create_train_state(cfg, seed=2, device="cpu")
    split = tstate.create_train_state(cfg, seed=2, device="cpu")
    _per_frame(split.model)
    for state in (paired, split):
        _perturb_stats(state.model, 2)
        for m in state.model.modules():
            if hasattr(m, "dropout_rate"):
                m.dropout_rate = dropout
    xyz1, xyz2 = _clouds(2)
    batch = {"xyz1": xyz1, "xyz2": xyz2,
             "gt_params": np.array([[0.4, 0.01, 0.0, 1.0, 0.0, 0.0, 0.0]] * 2, np.float32)}
    loss, grads, pending = _train_pass(paired, cfg, batch)
    ref_loss, ref_grads, ref_pending = _train_pass(split, cfg, batch)
    assert torch.isfinite(loss) and torch.equal(loss, ref_loss)
    assert grads.keys() == ref_grads.keys() and len(grads) > 200
    differ = [name for name in grads if not torch.equal(grads[name], ref_grads[name])]
    assert not differ, f"gradient leaves differ: {differ[:5]}"
    assert sum(float(g.abs().sum()) > 0 for g in grads.values()) > 200
    # every PointMLP of the pyramid holds the statistics of two chained calls
    assert pending.keys() == ref_pending.keys() and len(pending) > 100
    differ = [name for name in pending if not torch.equal(pending[name], ref_pending[name])]
    assert not differ, f"pending statistics differ: {differ[:5]}"


def test_pending_statistics_chain_frame_1_then_frame_2():
    """The second frame's call starts from the first's pending statistics:
    two calls of the level-1 MLP, in that order, reproduce what the pyramid
    leaves pending, and the reverse order does not."""
    model = PWCLONet(SMALL, seed=6, device="cpu")
    xyz1, xyz2 = (torch.from_numpy(a) for a in _clouds(3))
    model.pyramid(xyz1, xyz2, train=True, bn_momentum=0.3)
    got = dict(model.SetConv_0.PointMLP_0.pending)

    def chained(order):
        sa = SetConv(None, 64, 8, SMALL.sa_mlps[0])
        sa.load_state_dict(model.SetConv_0.state_dict())
        for xyz in order:
            sa(xyz, None, train=True, bn_momentum=0.3)
        return sa.PointMLP_0.pending

    forward, reverse = chained((xyz1, xyz2)), chained((xyz2, xyz1))
    assert all(torch.equal(got[k], forward[k]) for k in got)
    assert any(not torch.equal(got[k], reverse[k]) for k in got)


def test_sample_group_then_mlp_is_forward(rng):
    xyz = torch.from_numpy(rng.normal(size=(2, 96, 3)).astype(np.float32) * 3.0)
    feat = torch.from_numpy(rng.normal(size=(2, 96, 5)).astype(np.float32))
    for features, cin in ((None, None), (feat, 5)):
        sa = SetConv(cin, 24, 6, (8, 12), generator=torch.Generator().manual_seed(0))
        new_xyz, grouped = sa.sample_group(xyz, features)
        assert new_xyz.shape == (2, 24, 3) and grouped.shape == (2, 24, 6, 3 + (cin or 3))
        ref_xyz, ref = sa(xyz, features)
        assert torch.equal(new_xyz, ref_xyz) and torch.equal(sa.mlp(grouped), ref)
        # a stacked batch is sampled and grouped sample by sample
        one_xyz, one = sa.sample_group(xyz[1:], None if features is None else features[1:])
        assert torch.equal(one_xyz, new_xyz[1:]) and torch.equal(one, grouped[1:])


def test_paired_pyramid_on_cpu_launches_no_kernel():
    _cuda.reset_launch_counts()
    model = PWCLONet(SMALL, seed=0, device="cpu")
    xyz1, xyz2 = (torch.from_numpy(a) for a in _clouds(4, b=1))
    with torch.inference_mode():
        model(xyz1, xyz2)
    assert not any(_cuda.launch_counts().values())
