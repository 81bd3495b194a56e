"""PointNet++-style set conv / set upconv modules.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/models/pointnet2.py``:

- ``SetConv`` / ``SetUpConv``, the PWCLO-Net variants. With ``fused_eval``
  the grouped MLP + max-pool of either module runs as one kernel in eval
  mode (``ops/mlp.py``; ``train=True`` takes the unfused graph, whose
  groupings differentiate through the gather's scatter-add);
- ``SetConvMSG``, the upstream multi-scale ball-query set abstraction, with
  its group-all mode (``npoint=None``);
- ``FeaturePropagation``, three-NN inverse-distance interpolation, and
  ``LFPModuleMSG``, learnable multi-scale feature propagation.

The last three run their MLPs unfused and take the max over the samples
after them, as the reference does (it has no fused path there). ``dtype``
is the compute dtype of the unfused matmuls. Input widths are explicit
(Flax infers them at init); submodules carry Flax's automatic names.
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


def _ball_group(xyz, new_xyz, features, radius: float, nsample: int, use_xyz: bool):
    """Ball-query ``nsample`` neighbours of each centre, centre the grouped
    xyz, concat the features → ``(B, M, nsample, 3·use_xyz + C)``; with no
    features, the centred xyz."""
    idx = ops.ball_query(new_xyz, xyz, radius, nsample)
    if features is not None:
        grouped_xyz, grouped_feat = ops.group_points_multi(idx, xyz, features)
        grouped_xyz = grouped_xyz - new_xyz[:, :, None, :]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_feat], dim=-1)
        return grouped_feat
    return ops.group_points(xyz, idx) - new_xyz[:, :, None, :]


def _grouped_width(in_channels: Optional[int], use_xyz: bool) -> int:
    """Width of a grouping of xyz and ``in_channels`` features (None: xyz only)."""
    if in_channels is None:
        return 3
    return 3 + in_channels if use_xyz else in_channels


class SetConvMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    ``forward(xyz (B,N,3), features (B,N,C) or None)`` →
    ``(new_xyz (B,npoint or 1,3), new_features (B,npoint or 1,Σ mlps[i][-1]))``.
    Per scale: the ball query around the FPS centres, the MLP, the max over
    the samples; the scales concatenated. ``npoint=None`` is the group-all
    mode: one centre at the origin, every point in one uncentred
    neighbourhood, no sampling and no gather. ``in_channels`` is ``C``, or
    None when no features are given.
    """

    def __init__(self, in_channels: Optional[int], npoint: Optional[int],
                 radii: Sequence[Optional[float]], nsamples: Sequence[Optional[int]],
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps must have one entry a scale")
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        width = _grouped_width(in_channels, use_xyz)
        for i, mlp in enumerate(mlps):
            self.add_module(f"PointMLP_{i}", PointMLP(width, mlp, generator=generator, dtype=dtype))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], train: bool = False,
                bn_momentum=0.1):
        if self.npoint is not None:
            idx = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, idx)
        else:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            if self.npoint is not None:
                x = _ball_group(xyz, new_xyz, features, radius, nsample, self.use_xyz)
            else:
                # group-all: every point in one uncentred neighbourhood
                x = xyz[:, None] if features is None or self.use_xyz else None
                if features is not None:
                    f = features[:, None]
                    x = f if x is None else torch.cat([x, f], dim=-1)
            mlp = getattr(self, f"PointMLP_{i}")
            outs.append(mlp(x, train=train, bn_momentum=bn_momentum, maxpool=True))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """Three-NN inverse-distance feature propagation.

    ``forward(unknown (B,n,3), known (B,m,3) or None, unknown_feat (B,n,C1)
    or None, known_feat (B,m,C2))`` → ``(B, n, mlp[-1])``. ``known=None``
    broadcasts a global ``(B,1,C2)`` feature to every unknown point.
    ``known_channels`` is ``C2``, ``unknown_channels`` ``C1`` or None.
    """

    def __init__(self, known_channels: int, unknown_channels: Optional[int],
                 mlp: Sequence[int], generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.PointMLP_0 = PointMLP(known_channels + (unknown_channels or 0), mlp,
                                   generator=generator, dtype=dtype)

    def forward(self, unknown, known, unknown_feat, known_feat, train: bool = False,
                bn_momentum=0.1):
        if known is not None:
            sqdist, idx = ops.three_nn(unknown, known)
            x = ops.three_interpolate(known_feat, idx, sqdist)
        else:
            x = known_feat.expand(known_feat.shape[0], unknown.shape[1], known_feat.shape[-1])
        if unknown_feat is not None:
            x = torch.cat([x, unknown_feat], dim=-1)
        return self.PointMLP_0(x, train=train, bn_momentum=bn_momentum)


class LFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation from set 1 to set 2.

    ``forward(xyz2 (B,N2,3), xyz1 (B,N1,3), feat2 (B,N2,C2) or None,
    feat1 (B,N1,C1))`` → ``(B, N2, len(radii)·post_mlp[-1])``: per scale,
    ball-group set-1 features around the set-2 points, MLP, max over the
    samples, concat the set-2 features, the post MLP; the scales
    concatenated. The post MLP is one module shared by every scale (Flax's
    ``PointMLP_0``: it is built first); the scales' MLPs follow it.
    """

    def __init__(self, channels1: int, channels2: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 post_mlp: Sequence[int], use_xyz: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps must have one entry a scale")
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        kw = dict(generator=generator, dtype=dtype)
        self.PointMLP_0 = PointMLP(mlps[0][-1] + (channels2 or 0), post_mlp, **kw)
        width = _grouped_width(channels1, use_xyz)
        for i, mlp in enumerate(mlps):
            self.add_module(f"PointMLP_{i + 1}", PointMLP(width, mlp, **kw))

    def forward(self, xyz2, xyz1, feat2, feat1, train: bool = False, bn_momentum=0.1):
        kw = dict(train=train, bn_momentum=bn_momentum)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            x = _ball_group(xyz1, xyz2, feat1, radius, nsample, self.use_xyz)
            x = getattr(self, f"PointMLP_{i + 1}")(x, maxpool=True, **kw)  # (B, N2, mlp[-1])
            if feat2 is not None:
                x = torch.cat([x, feat2], dim=-1)
            outs.append(self.PointMLP_0(x, **kw))
        return torch.cat(outs, dim=-1)
