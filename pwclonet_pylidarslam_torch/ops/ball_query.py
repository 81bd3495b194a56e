"""Ball query: a fixed count of neighbours within a radius.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/ball_query.py``, with its
semantics: for each centre, the first ``nsample`` points by point index
within ``radius``; a row with fewer hits repeats its first hit; a row with
none is all 0.

The reference computes it outside any TPU kernel, from the dense pairwise
distances and one top-k, and so does the port, in plain PyTorch on every
device. The distances are :func:`ops.knn.pairwise_sqdist`'s, so that the
ball query and the kNN kernel round alike on the card and on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from pwclonet_pylidarslam_torch.ops.knn import pairwise_sqdist
from pwclonet_pylidarslam_torch.utils.timer import span


@span("op.ball_query")
@torch.no_grad()
def ball_query(
    centers: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    nsample: int,
    points_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """First ``nsample`` indices of ``points (B,N,3)`` within ``radius`` of
    each of ``centers (B,M,3)`` → ``(B, M, nsample)`` int32.

    A top-k over a key that ranks in-radius points by index and every other
    point after them (``N + index``); ``points_mask <= 0`` takes a point out.
    """
    n = points.shape[1]
    d = pairwise_sqdist(centers, points)  # (B, M, N)
    in_radius = d < radius * radius
    if points_mask is not None:
        in_radius = in_radius & (points_mask[:, None, :] > 0)
    point_ids = torch.arange(n, dtype=torch.int32, device=points.device)
    key = torch.where(in_radius, point_ids, n + point_ids)
    del d
    order = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).indices
    hit = torch.gather(in_radius, -1, order)
    idx = torch.where(hit, order, order[..., :1])  # pad by the first hit
    any_hit = in_radius.any(dim=-1, keepdim=True)
    return torch.where(any_hit, idx, 0).to(torch.int32)
