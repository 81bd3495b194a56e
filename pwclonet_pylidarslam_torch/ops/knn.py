"""Exact k-nearest-neighbour search with fixed shapes and optional masks.

``knn(query, ref, k, query_mask, ref_mask)`` returns ``(sqdists (B,S,k),
indices (B,S,k) int32)`` sorted ascending, with true squared distances
``max(|q|^2 + |r|^2 - 2 q.r, 0)`` and ties to the lower reference index,
as ``pwclonet_pylidarslam_tpu/ops/knn.py::knn`` defines them:

- a reference point with ``ref_mask <= 0`` takes distance ``1e10``, so it is
  picked only after every valid one;
- every slot whose distance is ``>= 5e9`` then takes slot 0's index and
  distance, so a query with fewer than ``k`` valid refs repeats its nearest
  valid hit, and one with none gets ``1e10`` at index 0;
- a query with ``query_mask <= 0`` gets index 0 and distance 0;
- when ``k`` exceeds the number of reference points, the ``k = N`` result
  is padded by repeating the nearest hit.

The port is exact everywhere. ``approx`` is accepted for the reference's
signature and changes nothing: the reference's approximate path is exact on
the CPU, and its TPU kernel's approximation is not carried over.

On a CUDA tensor :func:`knn` launches the kernel of ``csrc/knn.cu``, masks
or not; on a CPU tensor it runs :func:`knn_plain`. The search runs under
``torch.no_grad()`` and its results never require grad: the network uses
the indices only, as the reference does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pwclonet_pylidarslam_torch.ops import _cuda

MAX_K_CUDA = 32  # the kernel's sorted list: one key a lane of a warp
BIG = 1e10  # the distance of a masked reference point
INVALID = 0.5 * BIG  # a slot at or above this distance has no valid ref


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c a[..., c] * b[..., c]`` over the last axis, summed in channel
    order with every product and sum rounded on its own, as the kernel does."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def pairwise_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(B, S, N)`` as ``max(|q|^2 + |r|^2 - 2 q.r, 0)``."""
    q2 = _dot(query, query)[:, :, None]
    r2 = _dot(ref, ref)[:, None, :]
    cross = _dot(query[:, :, None, :], ref[:, None, :, :])
    return torch.clamp_min(q2 + r2 - 2.0 * cross, 0.0)


def masked_sqdist(query: torch.Tensor, ref: torch.Tensor,
                  ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`pairwise_sqdist` with masked reference points at ``1e10``."""
    dist = pairwise_sqdist(query, ref)
    if ref_mask is not None:
        dist = torch.where(ref_mask[:, None, :] > 0, dist, BIG)
    return dist


def fix_up(dists: torch.Tensor, idx: torch.Tensor,
           query_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots without a valid ref repeat slot 0; masked queries get 0 / 0."""
    invalid = dists >= INVALID
    idx = torch.where(invalid, idx[..., :1], idx)
    dists = torch.where(invalid, dists[..., :1], dists)
    if query_mask is not None:
        qm = query_mask[..., None] > 0
        idx = torch.where(qm, idx, 0)
        dists = torch.where(qm, dists, 0.0)
    return dists, idx


def knn_plain(
    query: torch.Tensor, ref: torch.Tensor, k: int,
    query_mask: Optional[torch.Tensor] = None, ref_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN for ``k <= N``: the masked pairwise formula, then a
    stable sort, so equal distances keep the lower index first, then the
    fix-up of :func:`fix_up`."""
    dist = masked_sqdist(query, ref, ref_mask)
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return fix_up(vals[..., :k].contiguous(), idx[..., :k].to(torch.int32), query_mask)


def _mask_bytes(name: str, mask: Optional[torch.Tensor], shape: tuple,
                device: torch.device) -> Optional[torch.Tensor]:
    """A mask as the kernel reads it: one byte a point, nonzero = valid."""
    if mask is None:
        return None
    if tuple(mask.shape) != shape or mask.device != device:
        raise ValueError(f"{name} must be {shape} on {device}, "
                         f"got {tuple(mask.shape)} on {mask.device}")
    return (mask > 0).contiguous()  # torch.bool: one byte, 0 or 1


def _knn_cuda(
    query: torch.Tensor, ref: torch.Tensor, k: int, warps: int = 0,
    query_mask: Optional[torch.Tensor] = None, ref_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel. ``warps`` is the number of queries a block serves; 0, which
    is what :func:`knn` passes, leaves the choice to the kernel, and the other
    values are there to be timed against it."""
    _cuda.check_cuda_tensor("query", query, (torch.float32,), 3)
    _cuda.check_cuda_tensor("ref", ref, (torch.float32,), 3)
    b, s, c = query.shape
    n = ref.shape[1]
    if c != 3 or ref.shape[0] != b or ref.shape[2] != 3 or ref.device != query.device:
        raise ValueError(
            f"the kNN kernel takes query (B,S,3) and ref (B,N,3) on one device, "
            f"got {tuple(query.shape)} and {tuple(ref.shape)}"
        )
    if not 1 <= k <= min(n, MAX_K_CUDA):
        raise ValueError(f"the kNN kernel takes 1 <= k <= min(N, {MAX_K_CUDA}), got k={k}, N={n}")
    qm = _mask_bytes("query_mask", query_mask, (b, s), query.device)
    rm = _mask_bytes("ref_mask", ref_mask, (b, n), query.device)
    dists = torch.empty((b, s, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, s, k), dtype=torch.int32, device=query.device)
    if b * s:
        _cuda.launch(
            "knn", "pwclo_knn", query.device,
            query.data_ptr(), ref.data_ptr(),
            None if qm is None else qm.data_ptr(), None if rm is None else rm.data_ptr(),
            b, s, n, k, dists.data_ptr(), idx.data_ptr(), warps, _cuda.stream_of(query),
        )
    return dists, idx


@torch.no_grad()
def knn(
    query: torch.Tensor, ref: torch.Tensor, k: int,
    query_mask: Optional[torch.Tensor] = None, ref_mask: Optional[torch.Tensor] = None,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query (B,S,C)`` in ``ref (B,N,C)``, exact,
    with the masks of the module docstring.

    CPU tensors take the plain version; CUDA tensors take the kernel, which
    raises on a shape or dtype it does not take.
    """
    del approx  # exact everywhere; see the module docstring
    n = ref.shape[1]
    if k > n:
        d, i = knn(query, ref, n, query_mask, ref_mask)
        reps = k - n
        return (
            torch.cat([d, d[..., :1].expand(*d.shape[:-1], reps)], dim=-1),
            torch.cat([i, i[..., :1].expand(*i.shape[:-1], reps)], dim=-1),
        )
    if query.device.type == "cpu":
        return knn_plain(query, ref, k, query_mask, ref_mask)
    return _knn_cuda(query.contiguous(), ref.contiguous(), k,
                     query_mask=query_mask, ref_mask=ref_mask)
