"""Fused attentive neighbourhood aggregate of the cost volume, eval mode.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/pallas/costvolume_kernel.py``.
Both attentive aggregates of the PWCLO-Net cost volume share one shape::

    enc = [p, q, q-p, |q-p|]                       (10-d spatial encoding)
    emb = MLP1([enc, center_feat, grouped_feat])   (or = grouped_feat)
    att = MLP2([ENC(enc), (center_feat,) emb])
    out = sum_k softmax_k(att) * emb

with BatchNorm folded into every stack. On CUDA tensors
:func:`attentive_aggregate` launches the kernel of
``csrc/attentive_aggregate.cu``, which computes all of it on chip and writes
only ``(B, S, D)``; on CPU tensors it runs :func:`attentive_aggregate_plain`.
The kernel multiplies on the tensor cores in 3xTF32 (every operand split
into two TF32 parts, three TF32 products a product) and sums in another
order: the two agree within atol 5e-5, rtol 1e-4. It reads each stack in the
layout ``ops/tf32x3.py::pack_fragments`` makes, built once per stack that
``PointMLP.folded()`` gives and kept with it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.ops.mlp import MAX_LAYERS, check_stack
from pwclonet_pylidarslam_torch.ops.tf32x3 import Stack, packed_fragments, sm_count, tile_centres
from pwclonet_pylidarslam_torch.utils.timer import span

ENC_WIDTH = 10


def _mlp(h: torch.Tensor, wb: Stack) -> torch.Tensor:
    for w, b in zip(*wb):
        h = torch.relu(torch.matmul(h, w) + b)
    return h


def attentive_aggregate_plain(center_xyz, grouped_xyz, center_feat, grouped_feat, enc_wb: Stack,
                              emb_wb: Optional[Stack], att_wb: Stack,
                              att_includes_center: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`attentive_aggregate`."""
    p = center_xyz[:, :, None, :].expand(grouped_xyz.shape)
    diff = grouped_xyz - p
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-20)
    enc = torch.cat([p, grouped_xyz, diff, dist], dim=-1)
    cf = center_feat[:, :, None, :].expand(*grouped_feat.shape[:3], center_feat.shape[-1])
    emb = grouped_feat if emb_wb is None else _mlp(torch.cat([enc, cf, grouped_feat], -1), emb_wb)
    e = _mlp(enc, enc_wb)
    att_in = [e, cf, emb] if att_includes_center else [e, emb]
    att = _mlp(torch.cat(att_in, dim=-1), att_wb)
    att = torch.exp(att - torch.amax(att, dim=-2, keepdim=True))
    att = att / torch.sum(att, dim=-2, keepdim=True)
    return torch.sum(att * emb, dim=-2)


def _attentive_aggregate_cuda(center_xyz, grouped_xyz, center_feat, grouped_feat, enc_wb, emb_wb,
                              att_wb, att_includes_center) -> torch.Tensor:
    f32 = (torch.float32,)
    _cuda.check_cuda_tensor("grouped_xyz", grouped_xyz, f32, 4)
    _cuda.check_cuda_tensor("grouped_feat", grouped_feat, f32, 4)
    _cuda.check_cuda_tensor("center_xyz", center_xyz, f32, 3)
    _cuda.check_cuda_tensor("center_feat", center_feat, f32, 3)
    b, s, k, _ = grouped_xyz.shape
    cc, cg = center_feat.shape[-1], grouped_feat.shape[-1]
    device = grouped_xyz.device
    expected = {"center_xyz": (center_xyz, (b, s, 3)), "grouped_xyz": (grouped_xyz, (b, s, k, 3)),
                "center_feat": (center_feat, (b, s, cc)), "grouped_feat": (grouped_feat, (b, s, k, cg))}
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be {shape} on {device}, got {tuple(t.shape)} on {t.device}")
    if k < 1 or cc < 1 or cg < 1:
        raise ValueError("K and the feature widths must be at least 1")
    enc_widths = check_stack("enc_wb", *enc_wb, ENC_WIDTH)
    emb_widths = () if emb_wb is None else check_stack("emb_wb", *emb_wb, ENC_WIDTH + cc + cg)
    d = emb_widths[-1] if emb_widths else cg
    att_in = enc_widths[-1] + (cc if att_includes_center else 0) + d
    att_widths = check_stack("att_wb", *att_wb, att_in)
    if att_widths[-1] != d:
        raise ValueError(f"attention width {att_widths[-1]} must equal the embedding width {d}")
    enc_p = packed_fragments(enc_wb, (ENC_WIDTH,), device)
    emb_p = None if emb_wb is None else packed_fragments(emb_wb, (ENC_WIDTH, cc, cg), device)
    att_parts = (enc_widths[-1], cc, d) if att_includes_center else (enc_widths[-1], d)
    att_p = packed_fragments(att_wb, att_parts, device)
    out = torch.empty((b, s, d), dtype=torch.float32, device=device)
    if out.numel():
        def ints(widths):
            return (len(widths), *widths, *(0,) * (MAX_LAYERS - len(widths)))

        tile = tile_centres(b * s, k, sm_count(device))
        _cuda.launch(
            "attentive_aggregate", "pwclo_attentive_aggregate", device,
            center_xyz.data_ptr(), grouped_xyz.data_ptr(), center_feat.data_ptr(),
            grouped_feat.data_ptr(), enc_p.data_ptr(),
            None if emb_p is None else emb_p.data_ptr(), att_p.data_ptr(),
            b * s, k, cc, cg, *ints(enc_widths), *ints(emb_widths), *ints(att_widths),
            int(bool(att_includes_center)), tile, out.data_ptr(), _cuda.stream_of(grouped_xyz),
        )
    return out


@span("op.attentive_aggregate")
def attentive_aggregate(center_xyz: torch.Tensor, grouped_xyz: torch.Tensor,
                        center_feat: torch.Tensor, grouped_feat: torch.Tensor, enc_wb: Stack,
                        emb_wb: Optional[Stack], att_wb: Stack,
                        att_includes_center: bool = False) -> torch.Tensor:
    """Fused attentive aggregate → ``(B, S, D)``.

    ``center_xyz (B, S, 3)``, ``grouped_xyz (B, S, K, 3)``, ``center_feat
    (B, S, Cc)``, ``grouped_feat (B, S, K, Cg)``; ``*_wb`` are BN-folded
    ``(weights, biases)`` stacks (``PointMLP.folded()``). ``emb_wb=None``
    takes ``grouped_feat`` itself as the embedding (the self-aggregation
    stage). CPU tensors take the plain version; CUDA tensors take the
    kernel, which raises on a dtype or shape it does not take."""
    if grouped_xyz.device.type == "cpu":
        return attentive_aggregate_plain(center_xyz, grouped_xyz, center_feat, grouped_feat,
                                         enc_wb, emb_wb, att_wb, att_includes_center)
    return _attentive_aggregate_cuda(
        center_xyz.contiguous(), grouped_xyz.contiguous(), center_feat.contiguous(),
        grouped_feat.contiguous(), enc_wb, emb_wb, att_wb, att_includes_center)
