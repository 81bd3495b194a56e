"""Attentive cost volume ("double attentive embedding").

PyTorch counterpart of
``pwclonet_pylidarslam_tpu/models/costvolume.py``:

1. cross-frame aggregate: for each (warped) F1 point, kNN(``nsample_q``) in
   F2; MLP1 over [10-d spatial encoding, F1 features, F2 features] gives the
   first flow embedding; MLP2 over [FC(spatial), embedding] gives attention
   weights, softmaxed over the neighbours → weighted sum;
2. self aggregate: kNN(``nsample``) of F1 in itself; MLP over [FC(spatial),
   F1 features, grouped embeddings] → attention → weighted sum of the grouped
   first embeddings.

With ``fused_eval`` each aggregate runs in eval mode as one kernel on the
BN-folded weights (``ops/costvolume.py``): encoding, both MLP stacks, softmax
and weighted sum on chip. The fused kernel has no backward: ``train=True``
takes the unfused graph. The parameters are the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch.models.layers import PointMLP, spatial_encoding


class CostVolume(nn.Module):
    """``forward(xyz1 (B,S,3), feat1 (B,S,C1), xyz2 (B,N,3), feat2 (B,N,C2))``
    → flow embedding ``(B, S, mlp2[-1])``."""

    def __init__(self, feat1_channels: int, feat2_channels: int, nsample: int = 4,
                 nsample_q: int = 32, mlp1: Sequence[int] = (128, 64, 64),
                 mlp2: Sequence[int] = (128, 64), generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_eval: bool = False):
        super().__init__()
        self.nsample = nsample
        self.nsample_q = nsample_q
        self.fused_eval = fused_eval
        d = mlp1[-1]
        kw = dict(generator=generator, dtype=dtype)
        # the reference's creation order, which names the Flax variables
        self.PointMLP_0 = PointMLP(10 + feat1_channels + feat2_channels, mlp1, **kw)
        self.PointMLP_1 = PointMLP(10, (d,), **kw)
        self.PointMLP_2 = PointMLP(2 * d, mlp2, **kw)
        self.PointMLP_3 = PointMLP(10, (d,), **kw)
        self.PointMLP_4 = PointMLP(d + feat1_channels + d, mlp2, **kw)

    def forward(self, xyz1, feat1, xyz2, feat2, train: bool = False,
                bn_momentum=0.1) -> torch.Tensor:
        fused = self.fused_eval and not train
        kw = dict(train=train, bn_momentum=bn_momentum)
        m_emb, m_enc1, m_att1, m_enc2, m_att2 = (
            self.PointMLP_0, self.PointMLP_1, self.PointMLP_2, self.PointMLP_3, self.PointMLP_4,
        )
        # ---- first (cross-frame) attentive aggregate
        _, idx_q = ops.knn(xyz1, xyz2, self.nsample_q, approx=True)
        q_xyz, q_feat = ops.group_points_multi(idx_q, xyz2, feat2)
        if fused:
            first = ops.attentive_aggregate(
                xyz1, q_xyz, feat1, q_feat, m_enc1.folded(), m_emb.folded(), m_att1.folded(),
                att_includes_center=False)
        else:
            enc = spatial_encoding(xyz1, q_xyz)  # (B, S, Kq, 10)
            p_feat = feat1[:, :, None, :].expand(*q_feat.shape[:3], feat1.shape[-1])
            emb = m_emb(torch.cat([enc, p_feat, q_feat], dim=-1), **kw)
            enc1 = m_enc1(enc, **kw)
            wq = m_att1(torch.cat([enc1, emb], dim=-1), **kw)
            wq = torch.softmax(wq, dim=-2)  # attention over the Kq neighbours
            first = torch.sum(wq * emb, dim=-2)  # (B, S, mlp1[-1])

        # ---- second (self) attentive aggregate
        _, idx_s = ops.knn(xyz1, xyz1, self.nsample, approx=True)
        s_xyz, s_emb = ops.group_points_multi(idx_s, xyz1, first)
        if fused:
            return ops.attentive_aggregate(
                xyz1, s_xyz, feat1, s_emb, m_enc2.folded(), None, m_att2.folded(),
                att_includes_center=True)
        enc_s = spatial_encoding(xyz1, s_xyz)
        enc2 = m_enc2(enc_s, **kw)
        p_feat_s = feat1[:, :, None, :].expand(*s_emb.shape[:3], feat1.shape[-1])
        wp = m_att2(torch.cat([enc2, p_feat_s, s_emb], dim=-1), **kw)
        wp = torch.softmax(wp, dim=-2)
        return torch.sum(wp * s_emb, dim=-2)  # (B, S, mlp2[-1])
