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

Data-parallel training (``parallel/data_parallel.py``) splits a batch over
ranks in equal contiguous blocks. Under :func:`sharded_batch` each rank's
train-mode ``PointMLP`` takes the moments of the whole batch
(:func:`batch_moments`, differentiable), and :func:`dropout` draws its masks
for the whole batch and keeps the rank's rows, so that every rank's
generator advances as one process's does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pwclonet_pylidarslam_torch import ops


class BatchShard(NamedTuple):
    """This rank's block of a batch split over the ``size`` ranks of
    ``group`` in equal contiguous blocks, in rank order."""

    group: object  # torch.distributed ProcessGroup
    rank: int
    size: int

    def rows(self, local: int) -> slice:
        """This rank's rows of the whole batch, ``local`` rows a rank."""
        return slice(self.rank * local, (self.rank + 1) * local)


# ``all_gather_into_tensor`` under its newer name, where torch has it: the
# ranks' tensors concatenated on axis 0
all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _WholeBatchMoments(torch.autograd.Function):
    """``(mean, var)`` of the whole batch from each rank's ``(mean_r,
    var_r)`` of as many rows, ``(C,)`` each: one all-gather, then Chan's
    formula for equal counts, the same on every rank: ``mean`` the average
    of the ``mean_r``, ``var`` the average of ``var_r + (mean_r − mean)²``.
    The backward is one all-reduce of the output gradients (the sum over
    the ranks' losses) and ``∂mean/∂mean_r = 1/n``, ``∂var/∂var_r = 1/n``,
    ``∂var/∂mean_r = 2 (mean_r − mean) / n``. On one rank both directions
    pass the values through unchanged, bit for bit."""

    @staticmethod
    def forward(ctx, mean: torch.Tensor, var: torch.Tensor, shard: "BatchShard"):
        local = torch.stack([mean, var])
        ranks = local.new_empty((shard.size * 2,) + tuple(mean.shape))
        all_gather_single(ranks, local, group=shard.group)
        means, variances = ranks.unflatten(0, (shard.size, 2)).unbind(1)
        whole_mean = means.sum(0) / shard.size
        whole_var = (variances + (means - whole_mean) ** 2).sum(0) / shard.size
        ctx.shard = shard
        ctx.save_for_backward(mean - whole_mean)
        return whole_mean, whole_var

    @staticmethod
    def backward(ctx, grad_mean: torch.Tensor, grad_var: torch.Tensor):
        (offset,) = ctx.saved_tensors
        n = ctx.shard.size
        grads = torch.stack([grad_mean, grad_var])
        dist.all_reduce(grads, group=ctx.shard.group)
        return torch.addcmul(grads[0] / n, grads[1], offset, value=2.0 / n), grads[1] / n, None


def batch_moments(rows: torch.Tensor, shard: Optional[BatchShard] = None):
    """``(var, mean)`` (biased) over axis 0 of ``rows (M, C)``. With
    ``shard``, of the whole batch whose rows this rank holds, every rank
    holding M: each rank's ``torch.var_mean``, combined over the ranks
    (:class:`_WholeBatchMoments`) so that no ``E[x²] − E[x]²`` cancels. On
    one rank the result is ``var_mean``'s, bit for bit."""
    var, mean = torch.var_mean(rows, dim=0, unbiased=False)
    if shard is None:
        return var, mean
    mean, var = _WholeBatchMoments.apply(mean, var, shard)
    return var, mean


@contextlib.contextmanager
def sharded_batch(module: nn.Module, shard: BatchShard):
    """Within the block, the train-mode forwards of ``module`` run on this
    rank's block of a batch split as ``shard`` says: every submodule with a
    ``batch_shard`` attribute (``PointMLP``, ``PoseCalculator``) takes the
    BatchNorm moments and dropout masks of the whole batch. After it, they
    run on their own batch again."""
    held = [m for m in module.modules() if hasattr(m, "batch_shard")]
    for m in held:
        m.batch_shard = shard
    try:
        yield
    finally:
        for m in held:
            m.batch_shard = None


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
    Without ``dtype`` the result has the input's dtype, so that a float64
    model on float64 inputs runs in float64 throughout.
    With ``fused=True`` the MLP + max-pool block of a 4-d input runs as one
    float32 kernel on the BN-folded weights, whatever ``dtype`` is; the fused
    kernel has no backward, so ``train=True`` takes the unfused graph.
    Under :func:`sharded_batch` the train-mode moments are those of the
    whole batch (:func:`batch_moments`).
    """

    batch_shard: Optional[BatchShard] = None

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
                var, mean = batch_moments(h.reshape(-1, h.shape[-1]), self.batch_shard)
                for name, batch in ((f"mean_{i}", mean), (f"var_{i}", var)):
                    running = self.pending.get(name, getattr(self, name))
                    self.pending[name] = (1.0 - bn_momentum) * running + bn_momentum * batch.detach()
            h = (h - mean) * torch.rsqrt(var + self.eps) * scale + bias
            if self.dtype is not None:
                h = h.to(self.dtype)
            x = torch.relu(h)
        if self.dtype is not None:
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


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            shard: Optional[BatchShard] = None) -> torch.Tensor:
    """Dropout whose mask is drawn from ``generator`` (on ``x``'s device; the
    default generator when None), kept entries scaled by ``1 / (1 - rate)``;
    the identity in eval mode or at rate 0. With ``shard``, ``x`` is this
    rank's block of the batch: the mask is drawn for the whole batch and the
    block's rows are kept."""
    if not train or rate == 0.0:
        return x
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        b = x.shape[0]
        whole = torch.rand((b * shard.size,) + tuple(x.shape[1:]), generator=generator,
                           device=x.device)
        keep = whole[shard.rows(b)] >= rate
    return x * keep / (1.0 - rate)


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
