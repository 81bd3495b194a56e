"""PWCLO-Net (Wang et al., CVPR 2021, arXiv:2012.00972) in plain PyTorch:
the forward at full width, the exp-weighted four-level loss, and the Adam
update with its cosine learning rate.

The network follows the published description as the program implements it
(the configuration file lists the channel plan): a siamese four-level
set-conv pyramid whose levels sample and group both frames but take
BatchNorm statistics of each frame on its own, the attentive cost volume at
level 3, the flow-embedding set conv to level 4, the coarse pose from the
masked embedding, and three warp-refinement levels. Output ``(B, 4, 7)``:
per level ``(t, q_wxyz)``, finest first. Unfused: every MLP is matmuls,
BatchNorm and ReLU; the max-pool and the attention are plain reductions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from benchmark.reference import nn as F

EMB = 64


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-10) + 1e-10)


def _encoding(centers, grouped):
    p = centers[:, :, None, :].expand(grouped.shape)
    diff = grouped - p
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-20)
    return torch.cat([p, grouped, diff, dist], dim=-1)


class Net:
    """The forward of one configuration over weights ``w``."""

    def __init__(self, config: Dict, w: F.Weights, precision: str = "float32",
                 train: bool = False, generator: Optional[torch.Generator] = None):
        self.c, self.w, self.precision = config, w, precision
        self.train, self.generator = train, generator
        self.dropout_rate = config["dropout"]

    def mlp(self, name, x, maxpool=False):
        return F.point_mlp(self.w, name, x, self.train, self.precision, maxpool)

    def sample_group(self, xyz, feat, npoint, nsample):
        new_xyz = F.gather(xyz, F.fps(xyz, npoint))
        _, idx = F.knn(new_xyz, xyz, nsample)
        if feat is None:
            g_xyz = F.group(xyz, idx)
            return new_xyz, torch.cat([g_xyz - new_xyz[:, :, None, :], g_xyz], dim=-1)
        g = F.group(torch.cat([xyz, feat], dim=-1), idx)
        return new_xyz, torch.cat([g[..., :3] - new_xyz[:, :, None, :], g[..., 3:]], dim=-1)

    def cost_volume(self, name, xyz1, feat1, xyz2, feat2, nsample, nsample_q):
        _, idx_q = F.knn(xyz1, xyz2, nsample_q)
        g = F.group(torch.cat([xyz2, feat2], dim=-1), idx_q)
        q_xyz, q_feat = g[..., :3], g[..., 3:]
        enc = _encoding(xyz1, q_xyz)
        p_feat = feat1[:, :, None, :].expand(*q_feat.shape[:3], feat1.shape[-1])
        emb = self.mlp(f"{name}.PointMLP_0", torch.cat([enc, p_feat, q_feat], dim=-1))
        enc1 = self.mlp(f"{name}.PointMLP_1", enc)
        wq = torch.softmax(self.mlp(f"{name}.PointMLP_2", torch.cat([enc1, emb], dim=-1)), dim=-2)
        first = torch.sum(wq * emb, dim=-2)
        _, idx_s = F.knn(xyz1, xyz1, nsample)
        g = F.group(torch.cat([xyz1, first], dim=-1), idx_s)
        s_xyz, s_emb = g[..., :3], g[..., 3:]
        enc2 = self.mlp(f"{name}.PointMLP_3", _encoding(xyz1, s_xyz))
        p_feat = feat1[:, :, None, :].expand(*s_emb.shape[:3], feat1.shape[-1])
        wp = torch.softmax(self.mlp(f"{name}.PointMLP_4", torch.cat([enc2, p_feat, s_emb], -1)),
                           dim=-2)
        return torch.sum(wp * s_emb, dim=-2)

    def set_upconv(self, name, fine_xyz, coarse_xyz, fine_feat, coarse_feat, nsample):
        _, idx = F.knn(fine_xyz, coarse_xyz, nsample)
        g = F.group(torch.cat([coarse_feat, coarse_xyz], dim=-1), idx)
        c = coarse_feat.shape[-1]
        x = torch.cat([g[..., :c], g[..., c:] - fine_xyz[:, :, None, :]], dim=-1)
        x = self.mlp(f"{name}.PointMLP_0", x, maxpool=True)
        return self.mlp(f"{name}.PointMLP_1", torch.cat([x, fine_feat], dim=-1))

    def head(self, name, dense):
        p = f"{name}.{dense}.Dense_0"
        return self.w[f"{p}.weight"], self.w[f"{p}.bias"]

    def pose(self, name, feat, mask):
        pooled = torch.sum(feat * torch.softmax(mask, dim=1), dim=1)
        big = F.linear(pooled, *self.head(name, "LinearHead_0"), self.precision)
        q = F.linear(F.dropout(big, self.dropout_rate, self.train, self.generator),
                     *self.head(name, "LinearHead_1"), self.precision)
        q = _unit(q)
        t = F.linear(F.dropout(big, self.dropout_rate, self.train, self.generator),
                     *self.head(name, "LinearHead_2"), self.precision)
        return q, t

    def refine(self, name, last, xyz_f1, feat_f1, xyz_f2, feat_f2, xyz_prev, feat_prev,
               mask_prev, q_c, t_c):
        up_feat = self.set_upconv(f"{name}.SetUpConv_0", xyz_f1, xyz_prev, feat_f1, feat_prev, 8)
        up_mask = self.set_upconv(f"{name}.SetUpConv_1", xyz_f1, xyz_prev, feat_f1, mask_prev, 8)
        warped = F.quat_apply(F.quat_normalize(q_c), t_c, xyz_f1)
        res = self.cost_volume(f"{name}.CostVolume_0", warped, feat_f1, xyz_f2, feat_f2, 4, 6)
        emb = self.mlp(f"{name}.FlowPredictor_0.PointMLP_0",
                       torch.cat([feat_f1, res, up_feat], dim=-1))
        mask = up_mask if last else self.mlp(f"{name}.FlowPredictor_1.PointMLP_0",
                                             torch.cat([up_mask, emb, feat_f1], dim=-1))
        q_d, t_d = self.pose(f"{name}.PoseCalculator_0", emb, mask)
        q = F.quat_multiply(q_d, q_c)
        t = F.quat_apply(F.quat_normalize(q_d), t_d, t_c[:, None, :])[:, 0]
        return q, t, emb, mask

    def __call__(self, xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
        c = self.c
        b = xyz1.shape[0]
        xyz, feat = torch.cat([xyz1, xyz2]), None
        f1, f2 = [], []
        for lvl in range(4):
            xyz, grouped = self.sample_group(xyz, feat, c["sa_npoints"][lvl],
                                             c["sa_nsamples"][lvl])
            name = f"SetConv_{lvl}.PointMLP_0"
            p1 = self.mlp(name, grouped[:b], maxpool=True)
            p2 = self.mlp(name, grouped[b:], maxpool=True)
            feat = torch.cat([p1, p2])
            f1.append((xyz[:b], p1))
            f2.append((xyz[b:], p2))
        (x1_1, p1_1), (x1_2, p1_2), (x1_3, p1_3), (_, p1_4) = f1
        (x2_1, p2_1), (x2_2, p2_2), (x2_3, p2_3), _ = f2
        flow = self.cost_volume("CostVolume_0", x1_3, p1_3, x2_3, p2_3, 4, 32)
        x1_4, g = self.sample_group(x1_3, flow, c["sa_npoints"][3], c["sa_nsamples"][3])
        emb4 = self.mlp("SetConv_4.PointMLP_0", g, maxpool=True)
        mask4 = self.mlp("FlowPredictor_0.PointMLP_0", torch.cat([p1_4, emb4], dim=-1))
        q4, t4 = self.pose("PoseCalculator_0", emb4, mask4)
        q3, t3, e3, m3 = self.refine("PoseWarpRefinement_0", False, x1_3, p1_3, x2_3, p2_3,
                                     x1_4, emb4, mask4, q4, t4)
        q2, t2, e2, m2 = self.refine("PoseWarpRefinement_1", False, x1_2, p1_2, x2_2, p2_2,
                                     x1_3, e3, m3, q3, t3)
        q1, t1, _, _ = self.refine("PoseWarpRefinement_2", True, x1_1, p1_1, x2_1, p2_1,
                                   x1_2, e2, m2, q2, t2)
        return torch.stack([torch.cat([t, _unit(q)], dim=-1)
                            for q, t in ((q1, t1), (q2, t2), (q3, t3), (q4, t4))], dim=1)


def loss(s: torch.Tensor, pred: torch.Tensor, gt: torch.Tensor,
         level_weights: Sequence[float]) -> torch.Tensor:
    """The exp-weighted loss: per level ``l_t e^{−s_t} + s_t + l_q e^{−s_q} +
    s_q``, ``l_t`` the mean of ``√((t̂ − t)² + 1e-10)``, ``l_q`` the mean of
    ``√(‖q̂/‖q̂‖ − q‖² + 1e-10)``, summed with ``level_weights`` fine first."""
    t_gt, q_gt = gt[:, :3], gt[:, 3:]
    total = 0.0
    for lvl, lw in enumerate(level_weights):
        lt = torch.mean(torch.sqrt((pred[:, lvl, :3] - t_gt) ** 2 + 1e-10))
        qn = _unit(pred[:, lvl, 3:])
        lq = torch.mean(torch.sqrt(torch.sum((qn - q_gt) ** 2, dim=-1) + 1e-10))
        total = total + lw * (lt * torch.exp(-s[0]) + s[0] + lq * torch.exp(-s[1]) + s[1])
    return total


def cosine_lr(count: int, peak: float, lr_min: float, total_steps: int) -> float:
    import math
    c = min(count, total_steps)
    alpha = lr_min / peak
    return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / total_steps)) + alpha)
