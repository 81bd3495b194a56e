"""Gather and group by index, channel-last ``(B, N, C)``, and the gather's
backward, a row scatter-add.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/gather.py``. On a CUDA tensor
:func:`gather_points` launches the kernel of ``csrc/gather.cu``, and its
gradient the deterministic scatter-add of ``csrc/scatter_add.cu``
(:func:`scatter_add_rows`); on a CPU tensor it runs
:func:`gather_points_plain`, and its gradient the plain scatter-add. The
gather is a bit-exact copy of the indexed rows. The scatter-add is a plan
(the index inverted) and a sum; :class:`ScatterPlan` keeps the plan for
callers that sum many update tensors over one index. Indices are int32,
assumed in range as in the reference, and get no gradient.
"""

from __future__ import annotations

import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.utils.timer import span


def gather_points_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src (B, N, C)`` gathered by ``idx (B, M)`` → ``(B, M, C)``."""
    index = idx.long()[..., None].expand(-1, -1, src.shape[-1])
    return torch.gather(src, 1, index)


def scatter_add_rows_plain(updates: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``out[b, j, :] = Σ_{m: idx[b, m] = j} updates[b, m, :]``:
    ``updates (B, M, C)``, ``idx (B, M)`` → ``(B, n, C)``."""
    b, m, c = updates.shape
    rows = idx.long() + n * torch.arange(b, device=idx.device)[:, None]
    out = updates.new_zeros((b * n, c))
    out.index_add_(0, rows.reshape(-1), updates.reshape(b * m, c))
    return out.reshape(b, n, c)


def _check_rows_and_idx(name: str, rows: torch.Tensor, idx: torch.Tensor) -> None:
    _cuda.check_cuda_tensor(name, rows, (torch.float32,), 3)
    _cuda.check_cuda_tensor("idx", idx, (torch.int32,), 2)
    if idx.shape[0] != rows.shape[0] or idx.device != rows.device:
        raise ValueError(
            f"idx must be (B, M) with B={rows.shape[0]} on {rows.device}, "
            f"got {tuple(idx.shape)} on {idx.device}"
        )


# A row of more than LONG_ROW updates is summed from shared memory, a shorter
# one by one thread a channel: ``kLongRow`` of ``csrc/scatter_add.cu``, which
# says how it was chosen. The plan's scratch has room to list such rows; the
# kernel refuses scratch too small for its own threshold.
LONG_ROW = 128


def scatter_plan_sizes(b: int, n: int, m: int) -> tuple:
    """``(tile, scratch ints, long rows)`` of a scatter-add plan: it ranks
    the entries in tiles of ``tile`` consecutive entries of a sample (a power
    of two, at least 256 and at least ``n``), and its scratch holds each
    entry's rank within its tile and the inverted index (each row's updates
    in ascending m), one int each an entry, then each tile's first slot of
    each row; beside those it lists the rows of more than ``LONG_ROW``
    updates, at most ``b * (m // (LONG_ROW + 1))`` of them."""
    tile = max(256, 1 << (n - 1).bit_length())
    tiles = max(1, -(-m // tile))
    return tile, 2 * b * m + b * tiles * n, b * (m // (LONG_ROW + 1))


def _gather_points_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_rows_and_idx("src", src, idx)
    b, n, c = src.shape
    m = idx.shape[1]
    out = torch.empty((b, m, c), dtype=src.dtype, device=src.device)
    if out.numel():
        _cuda.launch(
            "gather", "pwclo_gather", src.device,
            src.data_ptr(), idx.data_ptr(), b, n, m, c, out.data_ptr(), _cuda.stream_of(src),
        )
    return out


class ScatterPlan:
    """An index ``idx (B, M)`` into ``n`` rows, inverted once, to sum many
    update tensors over it: ``ScatterPlan(idx, n).sum(updates)`` is
    :func:`scatter_add_rows` ``(updates, idx, n)``, to the bit. On a CPU
    index the plan keeps the index and each sum runs the plain version; on a
    CUDA index it launches the kernel's plan once (int32, contiguous, or it
    raises), and each sum is one launch of the kernel's sum, which takes
    contiguous float32 updates ``(B, M, C)`` on the same device and raises
    on anything else."""

    @span("op.scatter_plan")
    def __init__(self, idx: torch.Tensor, n: int):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.idx, self.n = idx, n
        self._scratch = None
        if idx.device.type == "cpu":
            return
        _cuda.check_cuda_tensor("idx", idx, (torch.int32,), 2)
        b, m = idx.shape
        self.tile, ints, longs = scatter_plan_sizes(b, n, m)
        # and the long rows (row, first slot, length), and their count
        self._ints = ints + 3 * longs + 1
        self._scratch = torch.empty(self._ints, dtype=torch.int32, device=idx.device)
        if b:
            _cuda.launch(
                "scatter_add", "pwclo_scatter_plan", idx.device,
                idx.data_ptr(), b, n, m, self.tile, self._scratch.data_ptr(), self._ints,
                _cuda.stream_of(idx),
            )

    @span("op.scatter_sum")
    def sum(self, updates: torch.Tensor) -> torch.Tensor:
        """``out[b, j, :] = Σ_{m: idx[b, m] = j} updates[b, m, :]``, the rows
        of one ``j`` added in ascending ``m``."""
        if self._scratch is None:
            if updates.device.type != "cpu":
                raise ValueError(f"the plan's index lies on the CPU, the updates on "
                                 f"{updates.device}")
            return scatter_add_rows_plain(updates, self.idx, self.n)
        _check_rows_and_idx("updates", updates, self.idx)
        b, m = self.idx.shape
        if updates.shape[1] != m:
            raise ValueError(f"updates must be (B, M, C) with (B, M) = {(b, m)}, "
                             f"got {tuple(updates.shape)}")
        c = updates.shape[2]
        out = torch.empty((b, self.n, c), dtype=updates.dtype, device=updates.device)
        if out.numel():
            _cuda.launch(
                "scatter_add", "pwclo_scatter_sum", updates.device,
                updates.data_ptr(), self._scratch.data_ptr(), self._ints, b, self.n, m, c,
                self.tile, out.data_ptr(), _cuda.stream_of(updates),
            )
        return out


def _scatter_add_rows_cuda(updates: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    _check_rows_and_idx("updates", updates, idx)  # before the plan's launch
    if idx.shape[1] != updates.shape[1]:
        raise ValueError(f"idx must be (B, M) = {tuple(updates.shape[:2])}, "
                         f"got {tuple(idx.shape)}")
    return ScatterPlan(idx, n).sum(updates)


def scatter_add_rows(updates: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``updates (B, M, C)`` summed into ``(B, n, C)`` by ``idx (B, M)``:
    ``out[b, j, :] = Σ_{m: idx[b, m] = j} updates[b, m, :]``, the rows of one
    ``j`` added in ascending ``m``. CPU tensors take the plain version; CUDA
    tensors take the kernel (a plan, then a sum: two launches), which takes
    contiguous float32 updates and int32 indices and raises on anything
    else. Two calls on the same inputs agree to the bit. To sum many update
    tensors over one index, build one :class:`ScatterPlan`."""
    if updates.device.type == "cpu":
        return ScatterPlan(idx, n).sum(updates)
    return _scatter_add_rows_cuda(updates, idx, n)


class _GatherRows(torch.autograd.Function):
    """The gather with the scatter-add as its backward: the kernels on CUDA
    tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = src.shape[1]
        if src.device.type == "cpu":
            return gather_points_plain(src, idx)
        return _gather_points_cuda(src, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        # an incoming gradient is often a view (a slice of a concatenation):
        # the kernel takes contiguous rows
        return scatter_add_rows(grad.contiguous(), idx, ctx.n), None


@span("op.gather")
def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` gathered by ``idx (B, M)`` → ``(B, M, C)``:
    ``out[b, m, :] = points[b, idx[b, m], :]``. CPU tensors take the plain
    version; CUDA tensors take the kernel, which raises on a dtype or shape
    it does not take. The gradient with respect to ``points`` is
    :func:`scatter_add_rows` of the incoming gradient."""
    return _GatherRows.apply(points.contiguous(), idx.contiguous())


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` grouped by ``idx (B, M, K)`` → ``(B, M, K, C)``."""
    b, m, k = idx.shape
    flat = gather_points(points, idx.reshape(b, m * k))
    return flat.reshape(b, m, k, points.shape[-1])


def group_points_multi(idx: torch.Tensor, *tensors: torch.Tensor) -> tuple:
    """Group several same-``N`` tensors by one index set with one gather
    (and so one scatter-add in the backward).

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
