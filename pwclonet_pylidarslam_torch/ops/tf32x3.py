"""Host side of ``csrc/tf32x3.cuh``, the 3xTF32 tensor-core layers that both
fused kernels (``csrc/mlp_maxpool.cu``, ``csrc/attentive_aggregate.cu``) run
on: the weight layout the layers read, kept with the folded stack, and each
kernel's tile rule.

A block of 8 warps multiplies tiles of 16 rows (one mma M); a warp takes one
row tile and its share of a layer's n-tiles (8 columns each), at most 8, so
a layer wider than 64 columns allows at most 4 row tiles a block. The rules
read the SM count once per device, so no call queries the device in C.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

Stack = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]  # (weights, biases), folded
TILE_ROWS = 16  # rows of one tensor-core tile (mma M)
WARPS = 8  # a block's warps (kWarps)
WARP_COLUMNS = 64  # columns a warp multiplies: 8 n-tiles (kMaxWarpNTiles) of 8
MAX_BLOCK_ROWS = 64  # rows an aggregate block takes where the call has them


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def pack_fragments(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                   parts: Sequence[int]) -> torch.Tensor:
    """A folded stack in the layout ``csrc/tf32x3.cuh`` reads, one float32
    buffer on the weights' device. Layer by layer: the weight padded with
    zeros to ``(Kp, Np)``, both multiples of 8 (the first layer's rows part
    by part, ``parts`` the widths of its concatenated input; later layers
    have one part) and laid out in mma fragment order: for k-step ``s``,
    n-tile ``j`` and lane ``(g, t)`` = ``(lane // 4, lane % 4)`` the two
    floats ``w[8s+t, 8j+g], w[8s+t+4, 8j+g]``; then the bias, padded to
    ``Np``. The kernel splits each weight into its TF32 parts itself."""
    out = []
    for w, b in zip(weights, biases):
        cin, cout = w.shape
        if sum(parts) != cin:
            raise ValueError(f"parts {tuple(parts)} do not sum to the weight's {cin} rows")
        kp, np_ = sum(pad8(p) for p in parts), pad8(cout)
        full = w.new_zeros(kp, np_)
        src = dst = 0
        for p in parts:
            full[dst:dst + p, :cout] = w[src:src + p]
            src, dst = src + p, dst + pad8(p)
        # row 8s + 4h + t, column 8j + g  ->  (s, j, g, t, h)
        frags = full.view(kp // 8, 2, 4, np_ // 8, 8).permute(0, 3, 4, 2, 1)
        out += [frags.reshape(-1), torch.nn.functional.pad(b, (0, np_ - cout))]
        parts = (cout,)
    return torch.cat(out)


def packed_fragments(wb: Stack, parts: Sequence[int], device: torch.device) -> torch.Tensor:
    """:func:`pack_fragments` of ``wb``, kept in the stack's ``derived`` where
    it has one (a ``FoldedStack``: ``PointMLP.folded()``), so a model's
    stacks are laid out once and not on every call."""
    for t in (*wb[0], *wb[1]):
        if t.device != device:
            raise ValueError(f"parameters must lie on {device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"parameters must be float32, got {t.dtype}")
    derived = getattr(wb, "derived", None)
    key = ("fragments", tuple(parts))
    if derived is not None and key in derived:
        return derived[key]
    packed = pack_fragments(wb[0], wb[1], parts)
    if derived is not None:
        derived[key] = packed
    return packed


def tile_centres(centres: int, k: int, sms: int) -> int:
    """Whole centres an aggregate block takes: a tile of 16, 32 or 64 rows,
    the largest whose blocks still number at least half the ``sms`` SMs; at
    least one centre. Every block streams every layer's weights from L2, so a
    wider tile costs less a row; two blocks share an SM. On the path's shapes
    this beat both the largest tile that gives every SM a block and the one
    that gives every SM two (PERF.md)."""
    rows = TILE_ROWS
    while rows * 2 <= MAX_BLOCK_ROWS and rows * sms <= centres * k:
        rows *= 2
    return max(1, rows // k)


def max_tile_rows(widest: int) -> int:
    """The most rows a block multiplies at once when its widest layer has
    ``widest`` columns: 128 up to 64 columns, 64 up to 128."""
    warps_a_tile = -(-pad8(widest) // WARP_COLUMNS)
    return max(1, WARPS // warps_a_tile) * TILE_ROWS


def mlp_tile(centres: int, k: int, widest: int, sms: int) -> Tuple[int, int]:
    """``(block_centres, tile_rows)`` of an MLP + max-pool call: a block
    takes ``block_centres`` whole centres and multiplies their rows
    ``tile_rows`` at a time. The rows a block takes double from 16 up to
    :func:`max_tile_rows` while its blocks still number at least half the
    ``sms`` SMs; a centre longer than the tile is one block's, taken in
    tiles of the most rows."""
    limit = max_tile_rows(widest)
    rows = TILE_ROWS
    while rows * 2 <= limit and rows * sms <= centres * k:
        rows *= 2
    block = max(1, rows // k)
    return block, min(limit, -(-block * k // TILE_ROWS) * TILE_ROWS)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA ``device``, read once per device."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())
