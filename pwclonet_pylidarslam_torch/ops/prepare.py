"""The deep odometry's scan preparation, a chunk of scans at a time: each
scan's rows at the origin dropped, then ``n`` of the rest drawn.

Counterpart of the numpy ``PWCLONetOdometry._prepare`` of
``pwclonet_pylidarslam_tpu/slam/deep_odometry.py``, which prepares one scan
at a time. Here the chunk's scans lie in one ``rows (R, 3)`` tensor, float32
or float64 as the scans came (the origin test is made in their dtype, as
numpy makes it, and the drawn rows are rounded to float32 after it), scan
``b`` at rows ``offsets[b]:offsets[b + 1]`` (``offsets`` int64, T + 1
entries, on the rows' device). :func:`prepare` takes three steps:

- :func:`keep_rows`: which rows are kept (numpy's norm ``> 1e-6``) and, for
  each scan, its kept rows in order and their count. On a CUDA tensor one
  launch of ``pwclo_prepare_keep`` (``csrc/prepare.cu``), on a CPU tensor
  :func:`keep_rows_plain`.
- :func:`draw`: which of its kept rows a scan hands on, numpy's draw from
  the count alone, on the host; the ``(T, n)`` indices go to the device.
- :func:`take_rows`: the drawn rows copied out, one launch of
  ``pwclo_prepare_take`` or :func:`take_rows_plain`.

Both kernels agree with their plain versions to the bit, so the prepared
rows equal the reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.utils.timer import count, span

# a row is kept where its norm exceeds 1e-6 in the rows' dtype, as numpy
# compares a float32 array with a Python float
THRESHOLD = {torch.float32: float(np.float32(1e-6)), torch.float64: 1e-6}
DTYPES = tuple(THRESHOLD)


def away_from_origin(rows: torch.Tensor) -> torch.Tensor:
    """``(R,)`` bool: numpy's ``np.linalg.norm(rows, axis=-1) > 1e-6`` on
    float32 or float64 rows: each square rounded, the squares summed left to
    right, then a correctly rounded square root, all in the rows' dtype."""
    sq = rows * rows
    return torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2]) > THRESHOLD[rows.dtype]


def keep_rows_plain(rows: torch.Tensor, offsets: torch.Tensor) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """``(keep (R,) int32, counts (T,) int32)``: scan ``b``'s ``k``-th kept row
    (``k < counts[b]``) is row ``keep[offsets[b] + k]`` of the scan; the
    other entries are 0."""
    mask = away_from_origin(rows)
    keep = torch.zeros(len(rows), dtype=torch.int32, device=rows.device)
    bounds = offsets.tolist()
    counts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        kept = torch.nonzero(mask[lo:hi]).flatten()
        keep[lo: lo + len(kept)] = kept.to(torch.int32)
        counts.append(len(kept))
    return keep, torch.tensor(counts, dtype=torch.int32, device=rows.device)


def take_rows_plain(rows: torch.Tensor, offsets: torch.Tensor, keep: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """``(T, n, 3)`` float32: ``out[b, j] = rows[offsets[b] + keep[offsets[b]
    + idx[b, j]]]``, rounded to float32."""
    first = offsets[:-1, None]
    return rows[first + keep[first + idx.long()].long()].to(torch.float32)


def _check(rows: torch.Tensor, offsets: torch.Tensor) -> None:
    _cuda.check_cuda_tensor("rows", rows, DTYPES, 2)
    _cuda.check_cuda_tensor("offsets", offsets, (torch.int64,), 1)
    if rows.shape[1] != 3 or offsets.device != rows.device:
        raise ValueError(f"rows must be (R, 3) with offsets on its device, got "
                         f"{tuple(rows.shape)} and offsets on {offsets.device}")


def _keep_rows_cuda(rows: torch.Tensor, offsets: torch.Tensor) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    _check(rows, offsets)
    t = len(offsets) - 1
    keep = torch.empty(len(rows), dtype=torch.int32, device=rows.device)
    counts = torch.empty(t, dtype=torch.int32, device=rows.device)
    if t:
        _cuda.launch("prepare_keep", "pwclo_prepare_keep", rows.device, rows.data_ptr(),
                     offsets.data_ptr(), t, int(rows.dtype == torch.float64), keep.data_ptr(),
                     counts.data_ptr(), _cuda.stream_of(rows))
    return keep, counts


@span("op.prepare_keep")
def keep_rows(rows: torch.Tensor, offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan by scan, the rows away from the origin, in order: ``(keep (R,)
    int32, counts (T,) int32)`` as :func:`keep_rows_plain` gives them (on a
    CUDA tensor the entries past each scan's count are left unwritten).
    ``rows (R, 3)`` float32 or float64 and ``offsets (T + 1,)`` int64,
    contiguous, on one device; the offsets run from 0 to at most R. CPU
    tensors take the plain version; CUDA tensors take the kernel, which
    raises on anything else."""
    if rows.device.type == "cpu":
        return keep_rows_plain(rows, offsets)
    return _keep_rows_cuda(rows, offsets)


def draw(count: int, n: int) -> np.ndarray:
    """Which of a scan's ``count`` kept rows it hands on, ``(n,)`` int64: ``n``
    drawn without replacement from a generator seeded by the count, or,
    under ``n``, all of them and the rest drawn with replacement (seed 0)."""
    if count >= n:
        return np.random.default_rng(count).choice(count, n, replace=False)
    extra = np.random.default_rng(0).choice(count, n - count, replace=True)
    return np.concatenate([np.arange(count), extra])


def _take_rows_cuda(rows: torch.Tensor, offsets: torch.Tensor, keep: torch.Tensor,
                    idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    _check(rows, offsets)
    _cuda.check_cuda_tensor("keep", keep, (torch.int32,), 1)
    _cuda.check_cuda_tensor("idx", idx, (torch.int32,), 2)
    _cuda.check_cuda_tensor("out", out, (torch.float32,), 3)
    t, n = idx.shape
    if len(offsets) != t + 1 or out.shape != (t, n, 3):
        raise ValueError(f"idx (T, n) = {(t, n)} needs T + 1 offsets and out (T, n, 3), got "
                         f"{len(offsets)} offsets and out {tuple(out.shape)}")
    if out.numel():
        _cuda.launch("prepare_take", "pwclo_prepare_take", rows.device, rows.data_ptr(),
                     offsets.data_ptr(), keep.data_ptr(), idx.data_ptr(), t, n,
                     int(rows.dtype == torch.float64), out.data_ptr(), _cuda.stream_of(rows))
    count("odometry.scans_on_device", t)
    return out


@span("op.prepare_take")
def take_rows(rows: torch.Tensor, offsets: torch.Tensor, keep: torch.Tensor,
              idx: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The drawn rows, ``(T, n, 3)``: ``out[b, j]`` is scan ``b``'s kept row
    ``idx[b, j]`` (``keep`` from :func:`keep_rows`, ``idx (T, n)`` int32,
    each index under its scan's count), a bit-exact copy of float32 rows, or
    float64 rows rounded to float32; written into ``out`` where given
    (contiguous float32). CPU tensors take the plain version; CUDA tensors
    take the kernel, which raises on anything else."""
    if out is None:
        out = torch.empty((*idx.shape, 3), dtype=torch.float32, device=rows.device)
    if rows.device.type == "cpu":
        return out.copy_(take_rows_plain(rows, offsets, keep, idx))
    return _take_rows_cuda(rows, offsets, keep, idx, out)


def prepare(rows: torch.Tensor, offsets: torch.Tensor, n: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each scan of ``rows`` (as :func:`keep_rows` takes them) as the network
    takes it, ``(T, n, 3)`` float32, written into ``out`` where given: its
    rows at the origin dropped, then ``n`` drawn (:func:`draw`). The counts
    of kept rows are read back (on a CUDA tensor, the call's one wait on
    the device) and the drawn indices handed to the rows' device."""
    keep, counts = keep_rows(rows, offsets)
    with span("odometry.draw"):
        counts = counts.tolist()
        drawn = np.empty((len(counts), n), dtype=np.int32)
        for row, c in zip(drawn, counts):
            row[:] = draw(c, n)
    count("odometry.scans_padded", sum(c < n for c in counts))
    with span("odometry.h2d"):
        idx = torch.from_numpy(drawn).to(rows.device, non_blocking=True)
        count("h2d.bytes", drawn.nbytes)
    return take_rows(rows, offsets, keep, idx, out=out)
