"""PointNet++-style set conv / set upconv modules (PWCLO-Net variants).

PyTorch counterpart of ``SetConv`` and ``SetUpConv`` in
``pwclonet_pylidarslam_tpu/models/pointnet2.py``. With ``fused_eval`` the
grouped MLP + max-pool of either module runs as one kernel in eval mode
(``ops/mlp.py``; ``train=True`` takes the unfused graph, whose groupings
differentiate through the gather's scatter-add); ``dtype`` is the compute
dtype of the unfused matmuls. ``SetConvMSG``, ``FeaturePropagation`` and
``LFPModuleMSG`` are not ported yet (the point-set extras of ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.models.layers import PointMLP


class SetConv(nn.Module):
    """Set abstraction: FPS to ``npoint`` centers, kNN group, MLP, max-pool.

    ``forward(xyz (B,N,3), features (B,N,C) or None)`` →
    ``(new_xyz (B,npoint,3), new_features (B,npoint,mlp[-1]))``.
    ``in_channels`` is ``C``, or None for the first level, which groups the
    raw xyz in place of features.
    """

    def __init__(self, in_channels: Optional[int], npoint: int, nsample: int,
                 mlp: Sequence[int], generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_eval: bool = False):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.fused_eval = fused_eval
        self.PointMLP_0 = PointMLP(3 + (3 if in_channels is None else in_channels), mlp,
                                   generator=generator, dtype=dtype)

    def sample_group(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        """FPS, centre gather, kNN and grouping, each in one launch for the
        whole batch → ``(new_xyz (B,npoint,3), grouped (B,npoint,nsample,3+C))``,
        the input of the MLP. Every sample is sampled and grouped on its own,
        so a caller may stack independent clouds (the two frames of a pair)
        on the batch axis and run :meth:`mlp` on each part."""
        idx = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, idx)  # (B, npoint, 3)
        _, nn_idx = ops.knn(new_xyz, xyz, self.nsample, approx=True)
        if features is not None:
            grouped_xyz, grouped_feat = ops.group_points_multi(nn_idx, xyz, features)
            xyz_diff = grouped_xyz - new_xyz[:, :, None, :]
            return new_xyz, torch.cat([xyz_diff, grouped_feat], dim=-1)
        # first level: concat the raw grouped xyz
        grouped_xyz = ops.group_points(xyz, nn_idx)
        xyz_diff = grouped_xyz - new_xyz[:, :, None, :]
        return new_xyz, torch.cat([xyz_diff, grouped_xyz], dim=-1)

    def mlp(self, grouped: torch.Tensor, train: bool = False, bn_momentum=0.1) -> torch.Tensor:
        """MLP + max-pool over ``grouped (B,npoint,nsample,3+C)`` →
        ``(B, npoint, mlp[-1])``; in train mode one call is one batch of
        BatchNorm statistics."""
        return self.PointMLP_0(grouped, train=train, bn_momentum=bn_momentum, maxpool=True,
                               fused=self.fused_eval)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], train: bool = False,
                bn_momentum=0.1):
        new_xyz, grouped = self.sample_group(xyz, features)
        return new_xyz, self.mlp(grouped, train=train, bn_momentum=bn_momentum)


class SetUpConv(nn.Module):
    """Feature propagation coarse → fine by kNN set-upconv.

    ``forward(fine_xyz (B,Nf,3), coarse_xyz (B,Nc,3), fine_feat (B,Nf,Cf) or
    None, coarse_feat (B,Nc,Cc))`` → ``(B, Nf, post_mlp[-1])``: for every fine
    point, group its ``nsample`` nearest coarse points, concat the xyz
    difference, MLP, max-pool, concat the fine skip features, post MLP.
    """

    def __init__(self, coarse_channels: int, fine_channels: Optional[int], nsample: int,
                 mlp: Sequence[int], post_mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_eval: bool = False):
        super().__init__()
        self.nsample = nsample
        self.fused_eval = fused_eval
        self.PointMLP_0 = PointMLP(coarse_channels + 3, mlp, generator=generator, dtype=dtype)
        self.PointMLP_1 = PointMLP(mlp[-1] + (fine_channels or 0), post_mlp, generator=generator,
                                   dtype=dtype)

    def forward(self, fine_xyz, coarse_xyz, fine_feat, coarse_feat, train: bool = False,
                bn_momentum=0.1):
        _, nn_idx = ops.knn(fine_xyz, coarse_xyz, self.nsample, approx=True)
        grouped_feat, grouped_xyz = ops.group_points_multi(nn_idx, coarse_feat, coarse_xyz)
        xyz_diff = grouped_xyz - fine_xyz[:, :, None, :]
        x = torch.cat([grouped_feat, xyz_diff], dim=-1)
        x = self.PointMLP_0(x, train=train, bn_momentum=bn_momentum, maxpool=True,
                            fused=self.fused_eval)  # (B, Nf, mlp[-1])
        if fine_feat is not None:
            x = torch.cat([x, fine_feat], dim=-1)
        return self.PointMLP_1(x, train=train, bn_momentum=bn_momentum)
