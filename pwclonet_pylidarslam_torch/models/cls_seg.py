"""PointNet++ classification and semantic-segmentation networks.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/models/cls_seg.py``: the
upstream SSG/MSG classifiers and the SSG segmenter, channel-last, on the
modules of :mod:`models.pointnet2`. The channel plans are the upstream
recipes. Submodules carry Flax's automatic names (``SetConvMSG_i``,
``FeaturePropagation_i``, ``PointMLP_i``, ``Dense_0``), so that
``models/convert.py`` maps a reference variable tree one to one.

Dropout draws its masks from the generator a train-mode call is given
(``models/layers.py::dropout``). Weights are drawn at construction from
``torch.Generator().manual_seed(seed)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.models.layers import PointMLP, dropout
from pwclonet_pylidarslam_torch.models.pointnet2 import FeaturePropagation, SetConvMSG
from pwclonet_pylidarslam_torch.utils.timer import span


@dataclass(frozen=True)
class SAStage:
    """One set-abstraction stage (single- or multi-scale)."""

    npoint: Optional[int]
    radii: Tuple[Optional[float], ...]
    nsamples: Tuple[Optional[int], ...]
    mlps: Tuple[Tuple[int, ...], ...]


# upstream SSG classification plan (pointnet2_ssg_cls.py)
CLS_SSG: Tuple[SAStage, ...] = (
    SAStage(512, (0.2,), (64,), ((64, 64, 128),)),
    SAStage(128, (0.4,), (64,), ((128, 128, 256),)),
    SAStage(None, (None,), (None,), ((256, 512, 1024),)),
)

# upstream MSG classification plan (pointnet2_msg_cls.py)
CLS_MSG: Tuple[SAStage, ...] = (
    SAStage(
        512,
        (0.1, 0.2, 0.4),
        (16, 32, 128),
        ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
    ),
    SAStage(
        128,
        (0.2, 0.4, 0.8),
        (32, 64, 128),
        ((64, 64, 128), (128, 128, 256), (128, 128, 256)),
    ),
    SAStage(None, (None,), (None,), ((256, 512, 1024),)),
)

# upstream SSG semantic-segmentation plan (pointnet2_ssg_sem.py)
SEM_SSG: Tuple[SAStage, ...] = (
    SAStage(1024, (0.1,), (32,), ((32, 32, 64),)),
    SAStage(256, (0.2,), (32,), ((64, 64, 128),)),
    SAStage(64, (0.4,), (32,), ((128, 128, 256),)),
    SAStage(16, (0.8,), (32,), ((256, 256, 512),)),
)


def _dense(in_features: int, features: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` initialised as Flax's ``nn.Dense``: LeCun normal
    (truncated at two standard deviations) weight, zero bias."""
    layer = nn.Linear(in_features, features)
    # the truncated normal's standard deviation is 0.8796 of the untruncated one
    std = 1.0 / math.sqrt(in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _encoder(module: nn.Module, in_channels: Optional[int], stages: Sequence[SAStage],
             generator: torch.Generator, dtype) -> list:
    """Add ``SetConvMSG_i`` for each stage; returns each level's feature width
    (the input's first)."""
    widths = [in_channels]
    for i, stage in enumerate(stages):
        module.add_module(f"SetConvMSG_{i}", SetConvMSG(
            widths[-1], stage.npoint, stage.radii, stage.nsamples, stage.mlps,
            generator=generator, dtype=dtype))
        widths.append(sum(mlp[-1] for mlp in stage.mlps))
    return widths


class PointNet2Classification(nn.Module):
    """Shape classifier: SA stages → global feature → MLP head.

    ``forward(xyz (B,N,3), features (B,N,C) or None)`` → logits
    ``(B, num_classes)``. The last stage must be group-all (one centre).
    ``in_channels`` is ``C``, or None for xyz alone.
    """

    def __init__(self, num_classes: int, stages: Sequence[SAStage] = CLS_SSG,
                 head: Sequence[int] = (512, 256), dropout: float = 0.5,
                 in_channels: Optional[int] = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.dropout = dropout
        self.n_stages = len(stages)
        width = _encoder(self, in_channels, stages, g, dtype)[-1]
        for i, w in enumerate(head):
            self.add_module(f"PointMLP_{i}", PointMLP(width, (w,), generator=g, dtype=dtype))
            width = w
        self.n_head = len(head)
        self.Dense_0 = _dense(width, num_classes, g)
        self.to(device)
        self.eval()

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                train: bool = False, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, bn_momentum=bn_momentum)
        for i in range(self.n_stages):
            xyz, features = getattr(self, f"SetConvMSG_{i}")(xyz, features, **kw)
        x = features[:, 0]  # (B, C) global descriptor
        for i in range(self.n_head):
            x = getattr(self, f"PointMLP_{i}")(x, **kw)
            x = dropout(x, self.dropout, train, generator)
        return self.Dense_0(x)


class PointNet2Segmentation(nn.Module):
    """Per-point semantic segmentation: SA encoder + FP decoder.

    ``forward(xyz (B,N,3), features (B,N,C) or None)`` → logits
    ``(B, N, num_classes)``. The decoder propagates coarse → fine through one
    ``FeaturePropagation`` a level, ``fp_width`` wide and ``head_width`` at
    the finest level; then ``PointMLP((head_width,))``, dropout, ``Dense``.
    """

    def __init__(self, num_classes: int, stages: Sequence[SAStage] = SEM_SSG,
                 fp_width: int = 256, head_width: int = 128, dropout: float = 0.5,
                 in_channels: Optional[int] = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.dropout = dropout
        self.n_stages = len(stages)
        widths = _encoder(self, in_channels, stages, g, dtype)
        width = widths[-1]
        # Flax names the decoder's modules in the order it builds them: coarse first
        for j, level in enumerate(range(self.n_stages - 1, -1, -1)):
            w = fp_width if level > 0 else head_width
            self.add_module(f"FeaturePropagation_{j}", FeaturePropagation(
                width, widths[level], (w, w), generator=g, dtype=dtype))
            width = w
        self.PointMLP_0 = PointMLP(width, (head_width,), generator=g, dtype=dtype)
        self.Dense_0 = _dense(head_width, num_classes, g)
        self.to(device)
        self.eval()

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                train: bool = False, bn_momentum=0.1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, bn_momentum=bn_momentum)
        xyzs, feats = [xyz], [features]
        with span("model.encoder"):
            for i in range(self.n_stages):
                xyz, features = getattr(self, f"SetConvMSG_{i}")(xyz, features, **kw)
                xyzs.append(xyz)
                feats.append(features)
        x = feats[-1]
        with span("model.decoder"):
            for j, level in enumerate(range(self.n_stages - 1, -1, -1)):
                x = getattr(self, f"FeaturePropagation_{j}")(
                    xyzs[level], xyzs[level + 1], feats[level], x, **kw)
        with span("model.head"):
            x = self.PointMLP_0(x, **kw)
            x = dropout(x, self.dropout, train, generator)
            return self.Dense_0(x)
