"""PointNet++ SSG semantic segmentation (Qi et al., NeurIPS 2017,
arXiv:1706.02413) in plain PyTorch: the forward, the mean cross entropy and
the Adam update.

The upstream ``pointnet2_ssg_sem`` plan as the configuration file gives it:
four set-abstraction stages (FPS centres, a ball query of ``nsample`` points
within ``radius``, the grouped xyz centred and the features beside it, a
BatchNorm'd MLP, the max over the group), four feature-propagation stages
coarse to fine (three nearest known points by squared distance, weights
``1 / (d + 1e-8)`` normalised, the skip features beside them, an MLP), then
a 128-wide layer, dropout and the classifier.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import nn as F


def forward(config: Dict, w: F.Weights, xyz: torch.Tensor, feats: Optional[torch.Tensor],
            train: bool, precision: str,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits ``(B, N, num_classes)``."""
    xyzs, fs = [xyz], [feats]
    for i, stage in enumerate(config["stages"]):
        new_xyz = F.gather(xyz, F.fps(xyz, stage["npoint"]))
        idx = F.ball_query(new_xyz, xyz, stage["radius"], stage["nsample"])
        if feats is None:
            x = F.group(xyz, idx) - new_xyz[:, :, None, :]
        else:
            g = F.group(torch.cat([xyz, feats], dim=-1), idx)
            x = torch.cat([g[..., :3] - new_xyz[:, :, None, :], g[..., 3:]], dim=-1)
        feats = F.point_mlp(w, f"SetConvMSG_{i}.PointMLP_0", x, train, precision, maxpool=True)
        xyz = new_xyz
        xyzs.append(xyz)
        fs.append(feats)
    x = fs[-1]
    n = len(config["stages"])
    for j, level in enumerate(range(n - 1, -1, -1)):
        d, idx = F.knn(xyzs[level], xyzs[level + 1], 3)
        recip = 1.0 / (d + 1e-8)
        weights = recip / torch.sum(recip, dim=-1, keepdim=True)
        x = torch.sum(F.group(x, idx) * weights[..., None], dim=-2)
        if fs[level] is not None:
            x = torch.cat([x, fs[level]], dim=-1)
        x = F.point_mlp(w, f"FeaturePropagation_{j}.PointMLP_0", x, train, precision)
    x = F.point_mlp(w, "PointMLP_0", x, train, precision)
    x = F.dropout(x, config["dropout"], train, generator)
    return F.linear(x, w["Dense_0.weight"], w["Dense_0.bias"], precision)


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over every point."""
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1).long())


def staircase_lr(examples: float, config: Dict) -> float:
    """``lr · decay^⌊examples / decay_step⌋``, at least ``lr_clip``."""
    k = int(examples // config["decay_step"])
    return max(config["learning_rate"] * config["lr_decay"] ** k, config["lr_clip"])
