"""Shared neural building blocks, channel-last.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/models/layers.py``. A 1×1
conv over ``(B, N, K, C)`` is a matmul on the trailing axis. Parameters keep
the reference's names and layouts so that a Flax variable tree maps onto
them one to one (``models/convert.py``): ``PointMLP`` owns ``kernel_i``
``(Cin, Cout)``, ``scale_i`` and ``bias_i`` as parameters and the running
BatchNorm statistics ``mean_i``/``var_i`` as buffers.

In eval mode ``PointMLP`` can fold each BatchNorm into its matmul
(``folded()``) and run the whole MLP + max-pool block as one kernel
(``forward(..., fused=True)``, ``ops/mlp.py``). In train mode it normalises
with the batch statistics and leaves the new running statistics *pending*:
:func:`commit_batch_stats` writes them into the buffers (or keeps the old
ones where a step is skipped), :func:`discard_batch_stats` drops them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pwclonet_pylidarslam_torch import ops


class PointMLP(nn.Module):
    """Stack of (matmul → BatchNorm → ReLU) over the trailing channel axis;
    ``maxpool=True`` appends the max over axis -2.

    BatchNorm uses the running statistics in eval mode. With ``train=True``
    it uses the mean and the biased variance of the batch over all leading
    axes, taken in float32, and computes
    ``running = (1 - bn_momentum) * running + bn_momentum * batch`` (torch
    convention, the same biased variance) without writing it: the new values
    wait in ``pending`` for :func:`commit_batch_stats`. A second train-mode
    call before the commit (the siamese pyramid) updates the pending values.

    ``in_features`` is explicit (Flax infers it at init). ``dtype=
    torch.bfloat16`` runs the unfused matmuls in bf16 (inputs and kernel cast,
    BatchNorm in float32, activations cast back; the result is float32).
    With ``fused=True`` the MLP + max-pool block of a 4-d input runs as one
    float32 kernel on the BN-folded weights, whatever ``dtype`` is; the fused
    kernel has no backward, so ``train=True`` takes the unfused graph.
    """

    def __init__(self, in_features: int, features: Sequence[int], eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = tuple(features)
        self.eps = eps
        self.dtype = dtype
        self._folded = None  # (state key, (weights, biases))
        self.pending: Dict[str, torch.Tensor] = {}  # buffer name -> new running statistic
        cin = in_features
        for i, f in enumerate(self.features):
            kernel = torch.empty(cin, f)
            nn.init.xavier_uniform_(kernel, generator=generator)
            self.register_parameter(f"kernel_{i}", nn.Parameter(kernel))
            self.register_parameter(f"scale_{i}", nn.Parameter(torch.ones(f)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(f)))
            self.register_buffer(f"mean_{i}", torch.zeros(f))
            self.register_buffer(f"var_{i}", torch.ones(f))
            cin = f

    def _layers(self) -> list:
        return [
            tuple(getattr(self, f"{name}_{i}") for name in ("kernel", "scale", "bias", "mean", "var"))
            for i in range(len(self.features))
        ]

    @torch.no_grad()
    def folded(self) -> tuple:
        """The BN-folded ``(weights, biases)`` of the stack, for the fused
        kernels. Folded once and kept until a parameter or statistic is
        written in place (its ``_version`` moves) or replaced, as ``.to()``
        does (its ``data_ptr()`` moves)."""
        layers = self._layers()
        tensors = [t for layer in layers for t in layer]
        # inference tensors carry no version counter: nothing to watch, fold anew
        key = None if any(t.is_inference() for t in tensors) else tuple(
            (t._version, t.data_ptr(), t.device) for t in tensors)
        if key is None or self._folded is None or self._folded[0] != key:
            self._folded = (key, ops.fold_stack(layers, self.eps))
        return self._folded[1]

    def forward(self, x: torch.Tensor, train: bool = False, bn_momentum=0.1,
                maxpool: bool = False, fused: bool = False) -> torch.Tensor:
        if fused and maxpool and not train and x.dim() == 4:
            return ops.mlp_maxpool(x.float(), self.folded())
        for i, (kernel, scale, bias, mean, var) in enumerate(self._layers()):
            if self.dtype is not None:
                h = torch.matmul(x.to(self.dtype), kernel.to(self.dtype)).float()
            else:
                h = torch.matmul(x, kernel)
            if train:
                var, mean = torch.var_mean(h.reshape(-1, h.shape[-1]), dim=0, unbiased=False)
                for name, batch in ((f"mean_{i}", mean), (f"var_{i}", var)):
                    running = self.pending.get(name, getattr(self, name))
                    self.pending[name] = (1.0 - bn_momentum) * running + bn_momentum * batch.detach()
            h = (h - mean) * torch.rsqrt(var + self.eps) * scale + bias
            if self.dtype is not None:
                h = h.to(self.dtype)
            x = torch.relu(h)
        x = x.float()
        if maxpool:
            x = torch.amax(x, dim=-2)
        return x


def _pending_stats(module: nn.Module):
    """The submodules that hold pending statistics: ``PointMLP`` and
    ``posenet.BatchNorm``."""
    for m in module.modules():
        if getattr(m, "pending", None):
            yield m


@torch.no_grad()
def commit_batch_stats(module: nn.Module, keep: Optional[torch.Tensor] = None) -> None:
    """Write the running statistics that train-mode forwards left pending
    into the buffers of every module under ``module`` that holds them, in place (the
    folded weights are then refolded at their next use). ``keep`` is an
    optional 0-dim bool tensor on the buffers' device: where it is False the
    old statistics stay, without the host having to read it."""
    buffers, news = [], []
    for m in _pending_stats(module):
        for name, new in m.pending.items():
            buffers.append(getattr(m, name))
            news.append(new.to(buffers[-1].dtype))
        m.pending.clear()
    if not buffers:
        return
    if keep is not None:
        # one masked select over all statistics at once, not one per buffer
        flat = torch.where(keep, torch.cat([t.reshape(-1) for t in news]),
                           torch.cat([t.reshape(-1) for t in buffers]))
        news = [t.view_as(b) for t, b in zip(flat.split([b.numel() for b in buffers]), buffers)]
    torch._foreach_copy_(buffers, news)


def discard_batch_stats(module: nn.Module) -> None:
    """Drop the pending running statistics under ``module``."""
    for m in _pending_stats(module):
        m.pending.clear()


class LinearHead(nn.Module):
    """Plain linear layer (no activation, xavier-uniform weight)."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        nn.init.xavier_uniform_(self.Dense_0.weight, generator=generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


def spatial_encoding(centers: torch.Tensor, grouped: torch.Tensor) -> torch.Tensor:
    """The 10-d point-pair encoding ``[p, q, q−p, |q−p|]`` of the attentive
    cost volume: ``centers (B, S, 3)``, ``grouped (B, S, K, 3)`` →
    ``(B, S, K, 10)``."""
    p = centers[:, :, None, :].expand(grouped.shape)
    diff = grouped - p
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-20)
    return torch.cat([p, grouped, diff, dist], dim=-1)
