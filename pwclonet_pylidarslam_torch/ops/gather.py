"""Gather and group by index, channel-last ``(B, N, C)``.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/gather.py``. On a CUDA tensor
:func:`gather_points` launches the kernel of ``csrc/gather.cu``; on a CPU
tensor it runs :func:`gather_points_plain`. Both are bit-exact copies of the
indexed rows. Indices are int32 and assumed in range, as in the reference.
"""

from __future__ import annotations

import torch

from pwclonet_pylidarslam_torch.ops import _cuda



def gather_points_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src (B, N, C)`` gathered by ``idx (B, M)`` → ``(B, M, C)``."""
    index = idx.long()[..., None].expand(-1, -1, src.shape[-1])
    return torch.gather(src, 1, index)


def _gather_points_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _cuda.check_cuda_tensor("src", src, (torch.float32,), 3)
    _cuda.check_cuda_tensor("idx", idx, (torch.int32,), 2)
    b, n, c = src.shape
    m = idx.shape[1]
    if idx.shape[0] != b or idx.device != src.device:
        raise ValueError(
            f"idx must be (B, M) with B={b} on {src.device}, got {tuple(idx.shape)} on {idx.device}"
        )
    out = torch.empty((b, m, c), dtype=src.dtype, device=src.device)
    if out.numel():
        _cuda.launch(
            "gather", "pwclo_gather", src.device,
            src.data_ptr(), idx.data_ptr(), b, n, m, c, out.data_ptr(), _cuda.stream_of(src),
        )
    return out


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` gathered by ``idx (B, M)`` → ``(B, M, C)``:
    ``out[b, m, :] = points[b, idx[b, m], :]``. CPU tensors take the plain
    version; CUDA tensors take the kernel, which raises on a dtype or shape
    it does not take."""
    if points.device.type == "cpu":
        return gather_points_plain(points, idx)
    return _gather_points_cuda(points.contiguous(), idx.contiguous())


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` grouped by ``idx (B, M, K)`` → ``(B, M, K, C)``."""
    b, m, k = idx.shape
    flat = gather_points(points, idx.reshape(b, m * k))
    return flat.reshape(b, m, k, points.shape[-1])


def group_points_multi(idx: torch.Tensor, *tensors: torch.Tensor) -> tuple:
    """Group several same-``N`` tensors by one index set with one gather.

    The sources are concatenated (which promotes mixed dtypes to the widest)
    and each output slice is cast back to its source's dtype, so the result
    equals grouping each tensor on its own.
    """
    grouped = group_points(torch.cat(tensors, dim=-1), idx)
    outs, off = [], 0
    for t in tensors:
        w = t.shape[-1]
        outs.append(grouped[..., off : off + w].to(t.dtype))
        off += w
    return tuple(outs)
