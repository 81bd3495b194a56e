"""PWCLO-Net: hierarchical deep LiDAR odometry, channel-last.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/models/pwclonet.py``:

- siamese 4-level set-conv pyramid (the four ``SetConv`` modules are shared
  by both frames, which are sampled and grouped together, stacked on the
  batch axis), npoint 2048/1024/256/64, nsample 32/32/16/16, output
  channels 16/32/64/128;
- attentive cost volume at level 3 + flow-feature-encoding set conv → level
  4 flow embedding (64 ch);
- level-4 embedding mask (FlowPredictor) + PoseCalculator → coarse (q, t);
- 3 cascaded pose warp-refinement levels (3 → 2 → 1);
- output ``(B, 4, 7)``: per level ``(t (3), q_wxyz normalized (4))``, index
  0 = finest level (the final prediction).

Submodules carry the Flax auto-names (``SetConv_0``, ``PoseWarpRefinement_2``,
…) so that ``models/convert.py`` maps a Flax variable tree onto them by
path. ``PWCLONetConfig.fused_eval`` runs every set-conv MLP + max-pool block
and every attentive aggregate as one kernel each (``ops/mlp.py``,
``ops/costvolume.py``) in eval mode; ``compute_dtype="bfloat16"`` runs the
unfused MLP matmuls in bf16. ``forward(..., train=True)`` takes the unfused
graph whatever ``fused_eval`` says, normalises with batch statistics (the new
running statistics wait for ``models/layers.py::commit_batch_stats``) and
draws the pose heads' dropout masks from the generator it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pwclonet_pylidarslam_torch.core import rotation as rot
from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.models.costvolume import CostVolume
from pwclonet_pylidarslam_torch.models.layers import (
    BatchShard,
    LinearHead,
    PointMLP,
    discard_batch_stats,
    dropout,
)
from pwclonet_pylidarslam_torch.models.pointnet2 import SetConv, SetUpConv
from pwclonet_pylidarslam_torch.utils.timer import span

_EMB = 64  # flow-embedding / mask width of the reference channel plan
_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class FlowPredictor(nn.Module):
    """Embedding feature/mask predictor: MLP over concatenated features."""

    def __init__(self, in_features: int, mlp: Sequence[int] = (128, 64),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.PointMLP_0 = PointMLP(in_features, mlp, generator=generator, dtype=dtype)

    def forward(self, *features, train: bool = False, bn_momentum=0.1) -> torch.Tensor:
        x = torch.cat([f for f in features if f is not None], dim=-1)
        return self.PointMLP_0(x, train=train, bn_momentum=bn_momentum)


class PoseCalculator(nn.Module):
    """Masked aggregation → linear heads for (q, t).

    ``features/mask (B, N, C)``; the mask is softmaxed over N by the caller.
    The heads are linear, each behind its own dropout branch off the shared
    ``hidden``-wide projection. In train mode the two masks are drawn one
    after the other from ``generator`` (on the tensor's device; the default
    generator when None), kept entries scaled by ``1 / (1 - dropout_rate)``;
    in eval mode dropout is the identity. Under ``layers.sharded_batch``
    the masks are drawn for the whole batch and this rank keeps its rows.
    """

    batch_shard: Optional[BatchShard] = None

    def __init__(self, in_features: int, hidden: int = 256,
                 generator: Optional[torch.Generator] = None, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.LinearHead_0 = LinearHead(in_features, hidden, generator=generator)
        self.LinearHead_1 = LinearHead(hidden, 4, generator=generator)
        self.LinearHead_2 = LinearHead(hidden, 3, generator=generator)

    def _dropout(self, x: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(x, self.dropout_rate, train, generator, self.batch_shard)

    def forward(self, features, mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        pooled = torch.sum(features * mask, dim=1)  # (B, C)
        big = self.LinearHead_0(pooled)
        q = self.LinearHead_1(self._dropout(big, train, generator))
        q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-10) + 1e-10)
        t = self.LinearHead_2(self._dropout(big, train, generator))
        return q, t


def quat_warp(q: torch.Tensor, t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R(q)·p + t`` over ``points (B, N, 3)``."""
    return rot.quat_apply(rot.quat_normalize(q), t, points)


class PoseWarpRefinement(nn.Module):
    """One coarse-to-fine refinement level.

    set-upconv feature & mask propagation → quaternion warp of the fine F1
    points by the coarse pose → re-embedding cost volume (k=6) → feature /
    mask flow predictors → PoseCalculator → pose composition
    ``q = q_det ⊗ q_coarse``, ``t = R(q_det)·t_coarse + t_det``. The finest
    level has no mask predictor.
    """

    def __init__(self, fine_channels: int, last_level: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_eval: bool = False):
        super().__init__()
        g = generator
        kw = dict(generator=g, dtype=dtype)
        self.last_level = last_level
        self.SetUpConv_0 = SetUpConv(_EMB, fine_channels, 8, (128, 64), (64,),
                                     fused_eval=fused_eval, **kw)
        self.SetUpConv_1 = SetUpConv(_EMB, fine_channels, 8, (128, 64), (64,),
                                     fused_eval=fused_eval, **kw)
        self.CostVolume_0 = CostVolume(fine_channels, fine_channels, nsample=4, nsample_q=6,
                                       fused_eval=fused_eval, **kw)
        self.FlowPredictor_0 = FlowPredictor(fine_channels + 2 * _EMB, **kw)
        if not last_level:
            self.FlowPredictor_1 = FlowPredictor(fine_channels + 2 * _EMB, **kw)
        self.PoseCalculator_0 = PoseCalculator(_EMB, generator=g)

    def forward(self, xyz_f1, feat_f1, xyz_f2, feat_f2, xyz_prev, feat_prev, mask_prev,
                q_coarse, t_coarse, train: bool = False, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None):
        kw = dict(train=train, bn_momentum=bn_momentum)
        up_feat = self.SetUpConv_0(xyz_f1, xyz_prev, feat_f1, feat_prev, **kw)
        up_mask = self.SetUpConv_1(xyz_f1, xyz_prev, feat_f1, mask_prev, **kw)
        warped = quat_warp(q_coarse, t_coarse, xyz_f1)
        residual_emb = self.CostVolume_0(warped, feat_f1, xyz_f2, feat_f2, **kw)
        emb_feat = self.FlowPredictor_0(feat_f1, residual_emb, up_feat, **kw)
        if self.last_level:
            emb_mask = up_mask
        else:
            emb_mask = self.FlowPredictor_1(up_mask, emb_feat, feat_f1, **kw)
        w = torch.softmax(emb_mask, dim=1)  # over N
        q_det, t_det = self.PoseCalculator_0(emb_feat, w, train=train, generator=generator)
        q = rot.quat_multiply(q_det, q_coarse)
        t = quat_warp(q_det, t_det, t_coarse[:, None, :])[:, 0]
        return q, t, emb_feat, emb_mask


@dataclasses.dataclass(frozen=True)
class PWCLONetConfig:
    """Architecture hyperparameters (the reference's channel plan)."""

    num_points: int = 8192
    sa_npoints: Tuple[int, ...] = (2048, 1024, 256, 64)
    sa_nsamples: Tuple[int, ...] = (32, 32, 16, 16)
    sa_mlps: Tuple[Tuple[int, ...], ...] = (
        (8, 8, 16),
        (16, 16, 32),
        (32, 32, 64),
        (64, 64, 128),
    )
    bn_momentum_init: float = 0.5  # scheduled by the trainer
    compute_dtype: str = "float32"  # "bfloat16" puts the unfused MLP matmuls on bf16
    fused_eval: bool = False  # eval: one kernel per MLP + max-pool and per aggregate


def scaled_model_config(num_points: int, **overrides) -> PWCLONetConfig:
    """The one model-config rule shared by training, testing and inference:
    the reference channel plan at >= 2048 points, a proportionally scaled
    pyramid for smoke runs."""
    if num_points >= 2048:
        return PWCLONetConfig(num_points=num_points, **overrides)
    n = num_points
    return PWCLONetConfig(
        num_points=n,
        sa_npoints=(n // 4, n // 8, n // 16, n // 32),
        sa_nsamples=(8, 8, 8, 4),
        **overrides,
    )


class PWCLONet(nn.Module):
    """Full network. ``forward(xyz1 (B,N,3), xyz2 (B,N,3), train=False,
    bn_momentum=0.1, generator=None)`` → ``(pose_params (B, 4, 7), aux)``,
    params ``[t, q_wxyz]`` per level, fine→coarse (index 0 = final
    prediction). ``generator`` feeds the dropout masks of a train-mode call.

    Weights are a seeded init (xavier-uniform kernels, unit scale, zero bias
    and mean, unit var) unless loaded with ``models/convert.py``.
    """

    def __init__(self, config: PWCLONetConfig = PWCLONetConfig(), seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if config.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                             f"got {config.compute_dtype!r}")
        device = resolve_device(device)
        self.config = config
        g = torch.Generator().manual_seed(seed)
        kw = dict(generator=g, dtype=_COMPUTE_DTYPES[config.compute_dtype])
        fused = config.fused_eval
        mlps = config.sa_mlps
        for i in range(4):
            self.add_module(
                f"SetConv_{i}",
                SetConv(None if i == 0 else mlps[i - 1][-1], config.sa_npoints[i],
                        config.sa_nsamples[i], mlps[i], fused_eval=fused, **kw),
            )
        c1, c2, c3, c4 = (m[-1] for m in mlps)
        self.CostVolume_0 = CostVolume(c3, c3, nsample=4, nsample_q=32, fused_eval=fused, **kw)
        self.SetConv_4 = SetConv(_EMB, config.sa_npoints[3], config.sa_nsamples[3],
                                 (128, 64, 64), fused_eval=fused, **kw)
        self.FlowPredictor_0 = FlowPredictor(c4 + _EMB, **kw)
        self.PoseCalculator_0 = PoseCalculator(_EMB, generator=g)
        self.PoseWarpRefinement_0 = PoseWarpRefinement(c3, fused_eval=fused, **kw)
        self.PoseWarpRefinement_1 = PoseWarpRefinement(c2, fused_eval=fused, **kw)
        self.PoseWarpRefinement_2 = PoseWarpRefinement(c1, last_level=True, fused_eval=fused, **kw)
        self.to(device)
        self.eval()

    def pyramid(self, xyz1: torch.Tensor, xyz2: torch.Tensor, train: bool = False,
                bn_momentum=0.1):
        """The siamese set-conv pyramid: per frame the four levels' ``(xyz,
        features)``, fine to coarse. The same four modules serve both frames.

        The frames are stacked on the batch axis, so that each level samples
        and groups both in one launch of each point op (every sample on its
        own, so nothing changes in the result). The MLP runs once per frame,
        frame 1 first: in train mode each call is one frame's batch of
        statistics, and the second chains its pending running statistics onto
        the first's.
        """
        kw = dict(train=train, bn_momentum=bn_momentum)
        b = xyz1.shape[0]
        xyz, feat = torch.cat([xyz1, xyz2]), None
        f1, f2 = [], []
        for level in range(4):
            sa = getattr(self, f"SetConv_{level}")
            xyz, grouped = sa.sample_group(xyz, feat)
            p1 = sa.mlp(grouped[:b], **kw)
            p2 = sa.mlp(grouped[b:], **kw)
            feat = torch.cat([p1, p2])
            f1.append((xyz[:b], p1))
            f2.append((xyz[b:], p2))
        return f1, f2

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor, train: bool = False,
                bn_momentum=0.1, generator: Optional[torch.Generator] = None):
        if train:
            discard_batch_stats(self)  # of an earlier forward that was never committed
        kw = dict(train=train, bn_momentum=bn_momentum)
        with span("model.pyramid"):
            f1, f2 = self.pyramid(xyz1, xyz2, **kw)
        (x1_1, p1_1), (x1_2, p1_2), (x1_3, p1_3), (x1_4, p1_4) = f1
        (x2_1, p2_1), (x2_2, p2_2), (x2_3, p2_3), _ = f2

        with span("model.coarse"):
            # attentive cost volume at level 3 + flow feature encoding → level 4
            flow_emb = self.CostVolume_0(x1_3, p1_3, x2_3, p2_3, **kw)
            x1_4, emb4 = self.SetConv_4(x1_3, flow_emb, **kw)

            # level-4 embedding mask + coarse pose
            mask4 = self.FlowPredictor_0(p1_4, emb4, **kw)
            w4 = torch.softmax(mask4, dim=1)
            q4, t4 = self.PoseCalculator_0(emb4, w4, train=train, generator=generator)

        with span("model.refine"):
            # cascaded warp-refinement: level 3 → 2 → 1
            q3, t3, emb3, mask3 = self.PoseWarpRefinement_0(
                x1_3, p1_3, x2_3, p2_3, x1_4, emb4, mask4, q4, t4, generator=generator, **kw)
            q2, t2, emb2, mask2 = self.PoseWarpRefinement_1(
                x1_2, p1_2, x2_2, p2_2, x1_3, emb3, mask3, q3, t3, generator=generator, **kw)
            q1, t1, _, mask1 = self.PoseWarpRefinement_2(
                x1_1, p1_1, x2_1, p2_1, x1_2, emb2, mask2, q2, t2, generator=generator, **kw)

        def pack(q, t):
            qn = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-10) + 1e-10)
            return torch.cat([t, qn], dim=-1)

        pose_params = torch.stack(
            [pack(q1, t1), pack(q2, t2), pack(q3, t3), pack(q4, t4)], dim=1
        )  # (B, 4, 7)
        aux = {
            "embedding_mask": torch.linalg.norm(torch.softmax(mask1, dim=1), dim=-1),
            "point_cloud": x1_1,
        }
        return pose_params, aux


def params_to_pose_matrix(params: torch.Tensor) -> torch.Tensor:
    """``(..., 7)`` = (t, q_wxyz) → ``(..., 4, 4)``."""
    return se3.params_to_pose_quat(params)
