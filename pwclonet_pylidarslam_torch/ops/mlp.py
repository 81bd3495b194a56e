"""Fused shared MLP + max-pool over the neighbourhood, eval mode.

Counterpart of ``pwclonet_pylidarslam_tpu/ops/pallas/mlp_kernel.py``. With
the eval-mode BatchNorm folded into each matmul (:func:`fold_bn`) a set-conv
block is ``max_K relu(… relu(x·W0 + b0) … ·WL + bL)``. On a CUDA tensor
:func:`mlp_maxpool` launches the kernel of ``csrc/mlp_maxpool.cu``, which
keeps every intermediate on chip and writes only ``(B, S, Cout)``; on a CPU
tensor it runs :func:`mlp_maxpool_plain`. The two sum in different orders:
they agree within atol 3e-5, rtol 1e-4.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pwclonet_pylidarslam_torch.ops import _cuda

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
    """Fold every ``(kernel, scale, bias, mean, var)`` of a stack and return
    ``(weights, biases)`` as views of one packed float32 buffer
    ``W0, b0, W1, b1, …``: the layout the kernels read, so a stack folded
    here is launched without another copy."""
    folded = [fold_bn(*layer, eps=eps) for layer in layers]
    packed = torch.cat([t.reshape(-1).float() for wb in folded for t in wb])
    weights, biases, off = [], [], 0
    for w, b in folded:
        weights.append(packed[off : off + w.numel()].view(w.shape))
        off += w.numel()
        biases.append(packed[off : off + b.numel()])
        off += b.numel()
    return FoldedStack(weights, biases)


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


def packed_params(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """The stack as one contiguous float32 CUDA buffer ``W0, b0, W1, b1, …``.
    Views made by :func:`fold_stack` already are one: its first weight is
    returned as it is. Anything else is copied together."""
    parts = [t for wb in zip(weights, biases) for t in wb]
    for t in parts:
        if t.device != device:
            raise ValueError(f"parameters must lie on {device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"parameters must be float32, got {t.dtype}")
    ptr = parts[0].data_ptr()
    for t in parts:
        if not t.is_contiguous() or t.data_ptr() != ptr:
            return torch.cat([p.reshape(-1) for p in parts])
        ptr += t.numel() * t.element_size()
    return parts[0]


def mlp_maxpool_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x (B, S, K, Cin)`` → ``max_K relu-MLP(x) (B, S, Cout)`` with folded
    ``weights[i] (C_i, C_{i+1})`` and ``biases[i] (C_{i+1},)``."""
    h = x
    for w, b in zip(weights, biases):
        h = torch.relu(torch.matmul(h, w) + b)
    return torch.amax(h, dim=-2)


def _mlp_maxpool_cuda(x, weights, biases) -> torch.Tensor:
    _cuda.check_cuda_tensor("x", x, (torch.float32,), 4)
    b, s, k, cin = x.shape
    widths = check_stack("mlp_maxpool", weights, biases, cin)
    if k < 1:
        raise ValueError("x must have at least one neighbour per centre")
    params = packed_params(weights, biases, x.device)
    out = torch.empty((b, s, widths[-1]), dtype=torch.float32, device=x.device)
    if out.numel():
        padded = widths + (0,) * (MAX_LAYERS - len(widths))
        _cuda.launch(
            "mlp_maxpool", "pwclo_mlp_maxpool", x.device,
            x.data_ptr(), params.data_ptr(), b * s, k, len(widths), cin, *padded,
            out.data_ptr(), _cuda.stream_of(x),
        )
    return out


def mlp_maxpool(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x (B, S, K, Cin)`` → ``(B, S, Cout)``, BN already folded into
    ``weights``/``biases``. CPU tensors take the plain version; CUDA tensors
    take the kernel, which raises on a dtype or shape it does not take."""
    if x.device.type == "cpu":
        return mlp_maxpool_plain(x, weights, biases)
    return _mlp_maxpool_cuda(x.contiguous(), weights, biases)
