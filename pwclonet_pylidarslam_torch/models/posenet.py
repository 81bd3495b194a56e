"""PoseResNet: CNN pose regression over stacked vertex-map pairs.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/models/posenet.py``: a
ResNet-18/34/50 encoder (``BasicBlock`` for 18 and 34, ``Bottleneck`` for
50) over the channel-concatenated vertex maps of a frame window, a global
average pool, and two linear heads: the bias-free rotation head scaled by
``rotation_scale`` and the translation head.

Inputs are ``(B, seq, H, W, C)`` channel-last vertex maps, as the
reference takes them; the module stacks the frames on the channel axis
(``[frame 0 xyz, frame 1 xyz, ...]``) and runs the encoder channel-first.
Submodules carry the Flax auto-names (``ResNetEncoder_0``, ``BasicBlock_3``,
``Conv_1``, ``BatchNorm_0``, ``Dense_1``) so that a Flax variable tree maps
onto them (``models/convert.py``).

Two behaviours follow Flax rather than torch's defaults:

- ``padding="SAME"``: the total padding ``max((ceil(n/s) - 1)·s + k - n, 0)``
  is split with the smaller half first, so a stride-2 conv over an even
  size pads unevenly (3×3: 0 before, 1 after; the 7×7 stem: 2/3; the 3×3
  max-pool: 0/1, with −inf). :class:`Conv` and :func:`max_pool_same` pad
  explicitly;
- BatchNorm (:class:`BatchNorm`): momentum 0.99, ε 1e-5, the batch variance
  taken as ``E[x²] − E[x]²`` (clipped at 0) and the running variance updated
  with it (biased). In train mode the new running statistics wait in
  ``pending`` for ``layers.commit_batch_stats``, as ``PointMLP``'s do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pwclonet_pylidarslam_torch.device import resolve_device

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # Flax's nn.gelu default
    "sin": torch.sin,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}


def same_pads(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> Tuple[int, ...]:
    """``F.pad`` widths (last axis first) of Flax/XLA ``padding="SAME"``
    over the spatial ``size``."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


class Conv(nn.Conv2d):
    """Bias-free 2-d convolution with Flax's ``SAME`` padding; the weight is
    Flax's default init (``lecun_normal``: a normal truncated at two
    standard deviations, of variance 1/fan_in)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=0, bias=False)
        std = math.sqrt(1.0 / (in_channels * kernel * kernel)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, same_pads(x.shape[-2:], self.kernel_size, self.stride)))


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """Flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``, channel-first."""
    pads = same_pads(x.shape[-2:], (kernel, kernel), (stride, stride))
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), kernel, stride)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channel axis of ``(B, C, H, W)``."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.pending: Dict[str, torch.Tensor] = {}  # buffer name -> new running statistic

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = torch.mean(x, dim=(0, 2, 3))
            var = torch.clamp_min(torch.mean(x * x, dim=(0, 2, 3)) - mean * mean, 0.0)
            for name, batch in (("running_mean", mean), ("running_var", var)):
                running = self.pending.get(name, getattr(self, name))
                self.pending[name] = self.momentum * running + (1.0 - self.momentum) * batch.detach()
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 activation: Callable = torch.relu, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv(in_channels, features, 3, stride, generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, 1, generator)
        self.BatchNorm_1 = BatchNorm(features)
        if stride != 1 or in_channels != features:
            self.Conv_2 = Conv(in_channels, features, 1, stride, generator)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.activation(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = self.BatchNorm_2(self.Conv_2(x), train) if hasattr(self, "Conv_2") else x
        return self.activation(y + residual)


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (strided) → 1×1 expand ×4 (torchvision semantics)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 activation: Callable = torch.relu, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        out = self.expansion * features
        self.Conv_0 = Conv(in_channels, features, 1, 1, generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride, generator)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, out, 1, 1, generator)
        self.BatchNorm_2 = BatchNorm(out)
        if stride != 1 or in_channels != out:
            self.Conv_3 = Conv(in_channels, out, 1, stride, generator)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.activation(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.activation(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = self.BatchNorm_3(self.Conv_3(x), train) if hasattr(self, "Conv_3") else x
        return self.activation(y + residual)


class ResNetEncoder(nn.Module):
    """The stem (7×7 stride-2 conv, BatchNorm, activation, 3×3 stride-2
    max-pool) and four stages; returns the last feature map."""

    def __init__(self, in_channels: int, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 features: Sequence[int] = (64, 128, 256, 512), block: type = BasicBlock,
                 activation: Callable = torch.relu, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv(in_channels, 64, 7, 2, generator)
        self.BatchNorm_0 = BatchNorm(64)
        channels, i = 64, 0
        for stage, (blocks, feats) in enumerate(zip(stage_sizes, features)):
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                setattr(self, f"{block.__name__}_{i}",
                        block(channels, feats, stride, activation, generator))
                channels, i = block.expansion * feats, i + 1
        self.num_blocks = i
        self.block_name = block.__name__
        self.out_channels = channels

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.activation(self.BatchNorm_0(self.Conv_0(x), train))
        x = max_pool_same(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x, train)
        return x


@contextlib.contextmanager
def conv_precision(tf32: bool = False):
    """cuDNN's convolutions and cuBLAS's products with TF32 off (full fp32,
    as the reference computes) unless ``tf32``, and cuDNN's deterministic
    algorithms, for the block; the switches are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


MODEL_TO_PARAMS = {
    18: ((2, 2, 2, 2), BasicBlock),
    34: ((3, 4, 6, 3), BasicBlock),
    50: ((3, 4, 6, 3), Bottleneck),
}


@dataclasses.dataclass(frozen=True)
class PoseResNetConfig:
    sequence_len: int = 2
    num_input_channels: int = 3
    num_out_poses: int = 1
    resnet_model: int = 18  # 18 | 34 | 50
    activation: str = "relu"  # relu | gelu | sin | sigmoid | softplus
    rotation_scale: float = 0.1


class PoseResNet(nn.Module):
    """``forward(frames (B, seq, H, W, C), train=False)`` → euler pose
    params ``(B, num_out_poses, 6)`` = (t, euler-xyz). Built from ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: PoseResNetConfig = PoseResNetConfig(), seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if config.resnet_model not in MODEL_TO_PARAMS:
            raise ValueError(f"resnet_model must be one of {sorted(MODEL_TO_PARAMS)}, "
                             f"got {config.resnet_model}")
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        stages, block = MODEL_TO_PARAMS[config.resnet_model]
        self.ResNetEncoder_0 = ResNetEncoder(
            config.sequence_len * config.num_input_channels, stages, block=block,
            activation=ACTIVATIONS[config.activation], generator=gen)
        feats, out = self.ResNetEncoder_0.out_channels, 3 * config.num_out_poses
        self.Dense_0 = nn.Linear(feats, out, bias=False)  # rotation
        self.Dense_1 = nn.Linear(feats, out)  # translation
        # Flax's variance_scaling(0.01, "fan_avg", "uniform")
        limit = math.sqrt(3.0 * 0.01 / ((feats + out) / 2.0))
        with torch.no_grad():
            for dense in (self.Dense_0, self.Dense_1):
                nn.init.uniform_(dense.weight, -limit, limit, generator=gen)
            nn.init.zeros_(self.Dense_1.bias)
        self.to(dev)

    def forward(self, frames: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.config
        b, seq, h, w, c = frames.shape
        if seq != cfg.sequence_len:
            raise ValueError(f"expected {cfg.sequence_len} frames, got {seq}")
        x = frames.permute(0, 2, 3, 1, 4).reshape(b, h, w, seq * c).permute(0, 3, 1, 2)
        pooled = torch.mean(self.ResNetEncoder_0(x, train), dim=(2, 3))  # global average pool
        rot = cfg.rotation_scale * self.Dense_0(pooled)
        trans = self.Dense_1(pooled)
        return torch.cat([trans.reshape(b, cfg.num_out_poses, 3),
                          rot.reshape(b, cfg.num_out_poses, 3)], dim=-1)
