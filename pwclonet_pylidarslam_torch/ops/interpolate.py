"""Three-NN inverse-distance feature interpolation.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/interpolate.py``: the three
nearest known points of each unknown point by :func:`ops.knn.knn` (on a
CUDA tensor, the kNN kernel), then a weighted gather of their features (on
a CUDA tensor, the gather kernel, whose gradient is the scatter-add kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pwclonet_pylidarslam_torch.ops.gather import group_points
from pwclonet_pylidarslam_torch.ops.knn import knn
from pwclonet_pylidarslam_torch.utils.timer import span


@span("op.three_nn")
def three_nn(
    unknown: torch.Tensor,
    known: torch.Tensor,
    known_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest ``known (B,M,3)`` of each ``unknown (B,N,3)`` →
    ``(sqdists (B,N,3), idx (B,N,3) int32)``; *squared* distances."""
    return knn(unknown, known, 3, ref_mask=known_mask)


@span("op.three_interpolate")
def three_interpolate(
    features: torch.Tensor,
    idx: torch.Tensor,
    sqdist: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """``features (B, M, C)``, ``idx (B, N, 3)``, ``sqdist (B, N, 3)`` →
    ``(B, N, C)`` with weights ``(1 / (d_i + eps)) / sum_j 1 / (d_j + eps)``."""
    recip = 1.0 / (sqdist + eps)
    weights = recip / torch.sum(recip, dim=-1, keepdim=True)  # (B, N, 3)
    grouped = group_points(features, idx)  # (B, N, 3, C)
    return torch.sum(grouped * weights[..., None], dim=-2)
