"""Fused shared MLP + max-pool over the neighbourhood, eval mode.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/pallas/mlp_kernel.py``. With
the eval-mode BatchNorm folded into each matmul (:func:`fold_bn`) a set-conv
block is ``max_K relu(… relu(x·W0 + b0) … ·WL + bL)``. On a CUDA tensor
:func:`mlp_maxpool` launches the kernel of ``csrc/mlp_maxpool.cu``, which
keeps every intermediate on chip and writes only ``(B, S, Cout)``; on a CPU
tensor it runs :func:`mlp_maxpool_plain`. The kernel multiplies on the
tensor cores in 3xTF32 (``csrc/tf32x3.cuh``: every operand split into two
TF32 parts, three TF32 products a product) and sums in another order: the
two agree within atol 3e-5, rtol 1e-4. It reads the stack in the layout
``ops/tf32x3.py::pack_fragments`` makes, built once per stack that
``PointMLP.folded()`` gives and kept with it; the wrapper picks the tile
(``ops/tf32x3.py::mlp_tile``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.ops.tf32x3 import Stack, mlp_tile, packed_fragments, sm_count
from pwclonet_pylidarslam_torch.utils.timer import span

MAX_LAYERS = 3  # layers per stack the kernels take


def fold_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval-mode batch norm into the preceding bias-free matmul:
    ``BN(x@W) = x @ (W*g) + (bias - mean*g)`` with ``g = scale/sqrt(var+eps)``."""
    g = scale * torch.rsqrt(var + eps)
    return kernel * g[None, :], bias - mean * g


class FoldedStack(tuple):
    """``(weights, biases)`` of a folded stack, as :func:`fold_stack` gives
    it, with ``derived``: layouts a kernel builds from the stack (keyed by
    the kernel's own key), kept as long as the stack is."""

    def __new__(cls, weights, biases):
        stack = super().__new__(cls, (tuple(weights), tuple(biases)))
        stack.derived = {}
        return stack


def fold_stack(layers: Sequence[Sequence[torch.Tensor]], eps: float = 1e-5) -> FoldedStack:
    """Fold every ``(kernel, scale, bias, mean, var)`` of a stack into
    float32 ``(weights, biases)``."""
    folded = [fold_bn(*layer, eps=eps) for layer in layers]
    return FoldedStack([w.float() for w, _ in folded], [b.float() for _, b in folded])


def check_stack(name: str, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                cin: int) -> Tuple[int, ...]:
    """Raise unless the stack chains from ``cin``; returns its output widths."""
    if not 1 <= len(weights) <= MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(f"{name}: 1 to {MAX_LAYERS} layers with one bias each, got "
                         f"{len(weights)} weights and {len(biases)} biases")
    widths = []
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != cin or b.shape != (w.shape[1],):
            raise ValueError(f"{name}: layer {i} must be ({cin}, Cout) with bias (Cout,), got "
                             f"{tuple(w.shape)} and {tuple(b.shape)}")
        cin = w.shape[1]
        widths.append(cin)
    return tuple(widths)


def mlp_maxpool_plain(x: torch.Tensor, wb: Stack) -> torch.Tensor:
    """``x (B, S, K, Cin)`` → ``max_K relu-MLP(x) (B, S, Cout)`` with the
    folded stack ``wb``: ``weights[i] (C_i, C_{i+1})``, ``biases[i]
    (C_{i+1},)``."""
    h = x
    for w, b in zip(*wb):
        h = torch.relu(torch.matmul(h, w) + b)
    return torch.amax(h, dim=-2)


def _mlp_maxpool_cuda(x: torch.Tensor, wb: Stack,
                      tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The kernel. ``tile`` is ``(block_centres, tile_rows)``; None, which is
    what :func:`mlp_maxpool` passes, takes :func:`mlp_tile`'s, and the other
    values are there to be timed against it."""
    _cuda.check_cuda_tensor("x", x, (torch.float32,), 4)
    b, s, k, cin = x.shape
    widths = check_stack("mlp_maxpool", *wb, cin)
    if k < 1:
        raise ValueError("x must have at least one neighbour per centre")
    params = packed_fragments(wb, (cin,), x.device)
    out = torch.empty((b, s, widths[-1]), dtype=torch.float32, device=x.device)
    if out.numel():
        block_centres, tile_rows = tile or mlp_tile(b * s, k, max(widths), sm_count(x.device))
        padded = widths + (0,) * (MAX_LAYERS - len(widths))
        _cuda.launch(
            "mlp_maxpool", "pwclo_mlp_maxpool", x.device,
            x.data_ptr(), params.data_ptr(), b * s, k, len(widths), cin, *padded,
            block_centres, tile_rows, out.data_ptr(), _cuda.stream_of(x),
        )
    return out


@span("op.mlp_maxpool")
def mlp_maxpool(x: torch.Tensor, wb: Stack) -> torch.Tensor:
    """``x (B, S, K, Cin)`` → ``(B, S, Cout)``, with ``wb`` the stack's
    ``(weights, biases)``, BN already folded (``PointMLP.folded()``). CPU
    tensors take the plain version; CUDA tensors take the kernel, which
    raises on a dtype or shape it does not take."""
    if x.device.type == "cpu":
        return mlp_maxpool_plain(x, wb)
    return _mlp_maxpool_cuda(x.contiguous(), wb)
