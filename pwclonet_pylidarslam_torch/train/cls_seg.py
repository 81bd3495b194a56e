"""Train state and train/eval steps for the PointNet++ cls/semseg family.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/cls_seg.py``, the
upstream recipe: Adam (AdamW when ``weight_decay > 0``) with a staircase
learning rate ``lr · lr_decay^⌊examples/decay_step⌋`` clipped at
``LR_CLIP``, and a BatchNorm-momentum staircase ``bn_momentum ·
bnm_decay^⌊examples/decay_step⌋`` clipped at ``BNM_CLIP``. Both are keyed by
the examples seen before the step (``step · batch_size``), which is what
the reference's optimizer schedule sees; the learning rate is set on the
optimizer before each step. Softmax cross entropy with integer labels and
the mean accuracy serve ``(B, C)`` and ``(B, N, C)`` logits alike.

A train step leaves the new running statistics pending during the forward
and commits them after the update (``models/layers.py``); dropout draws
from the state's generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats
from pwclonet_pylidarslam_torch.train.state import _to_device
from pwclonet_pylidarslam_torch.utils.timer import count, span

LR_CLIP = 1e-5
BNM_CLIP = 1e-2


@dataclasses.dataclass(frozen=True)
class ClsSegTrainConfig:
    # the upstream cls recipe; semseg uses lr_decay=0.5, decay_step=3e5
    learning_rate: float = 1e-3
    lr_decay: float = 0.7
    decay_step: float = 2e4  # in examples seen
    weight_decay: float = 0.0
    bn_momentum: float = 0.5
    bnm_decay: float = 0.5
    batch_size: int = 32


def lr_at(config: ClsSegTrainConfig, examples_seen: float) -> float:
    """Staircase learning rate after ``examples_seen`` examples."""
    k = math.floor(examples_seen / config.decay_step)
    return max(config.learning_rate * config.lr_decay**k, LR_CLIP)


def bn_momentum_at(config: ClsSegTrainConfig, examples_seen: float) -> float:
    """Staircase BatchNorm momentum (torch convention) after ``examples_seen``."""
    k = math.floor(examples_seen / config.decay_step)
    return max(config.bn_momentum * config.bnm_decay**k, BNM_CLIP)


def make_optimizer(model: torch.nn.Module, config: ClsSegTrainConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW (decoupled decay on every parameter) when
    ``weight_decay > 0``, over the model's parameters; the learning rate is
    set before each step."""
    params = list(model.parameters())
    if config.weight_decay > 0:
        return torch.optim.AdamW(params, lr=config.learning_rate, eps=1e-8,
                                 weight_decay=config.weight_decay)
    return torch.optim.Adam(params, lr=config.learning_rate, eps=1e-8)


class ClsSegTrainState:
    """The network (parameters and running statistics), its optimizer, the
    count of train steps taken and the dropout generator."""

    def __init__(self, model: torch.nn.Module, config: ClsSegTrainConfig,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.optimizer = make_optimizer(model, config)
        self.step = 0
        self.generator = generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_cls_seg_state(model: torch.nn.Module, config: ClsSegTrainConfig,
                         seed: int = 0) -> ClsSegTrainState:
    """A train state over ``model`` with a fresh optimizer and a dropout
    generator on the model's device seeded with ``seed + 1``."""
    device = next(model.parameters()).device
    return ClsSegTrainState(model, config, torch.Generator(device=device).manual_seed(seed + 1))


def split_inputs(points: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(B, N, C)`` → xyz ``(B, N, 3)`` and the other channels (or None)."""
    return points[..., :3], (points[..., 3:] if points.shape[-1] > 3 else None)


def ce_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross entropy and mean accuracy; ``logits (..., C)``,
    integer ``labels (...)``."""
    flat = logits.reshape(-1, logits.shape[-1])
    target = labels.reshape(-1).long()
    loss = F.cross_entropy(flat, target)
    acc = (torch.argmax(flat, dim=-1) == target).float().mean()
    return loss, acc


def cls_seg_loss_and_grads(config: ClsSegTrainConfig, state: ClsSegTrainState, batch: Mapping):
    """Train-mode forward, loss and backward: ``(loss, accuracy, grads)``,
    ``grads`` in the order of ``model.parameters()`` (zeros for one the loss
    does not reach). The new running statistics are left pending and the
    generator has drawn the dropout masks; nothing else changes."""
    with span("train.h2d"):
        batch = _to_device(batch, state.device)
    with span("train.forward"):
        xyz, features = split_inputs(batch["points"])
        logits = state.model(xyz, features, train=True,
                             bn_momentum=bn_momentum_at(config, state.step * config.batch_size),
                             generator=state.generator)
        loss, acc = ce_and_accuracy(logits, batch["labels"])
    params = list(state.model.parameters())
    with span("train.backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss.detach(), acc, grads


@span("train.step")
def cls_seg_train_step(config: ClsSegTrainConfig, state: ClsSegTrainState,
                       batch: Mapping) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``state``, in place. ``batch``: ``{"points":
    (B, N, C), "labels": (B,) or (B, N)}``, numpy or tensors. Returns the
    log: ``loss`` and ``accuracy`` (0-dim tensors on the device), ``lr`` and
    ``bn_momentum`` of the step."""
    examples = state.step * config.batch_size
    loss, acc, grads = cls_seg_loss_and_grads(config, state, batch)
    lr = lr_at(config, examples)
    with span("train.optimizer"):
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        commit_batch_stats(state.model)
    state.step += 1
    count("train.steps")
    return {"loss": loss, "accuracy": acc, "lr": lr,
            "bn_momentum": bn_momentum_at(config, examples)}


@torch.no_grad()
def cls_seg_eval_step(state: ClsSegTrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Forward with the running statistics and no dropout: ``loss`` and
    ``accuracy``."""
    batch = _to_device(batch, state.device)
    xyz, features = split_inputs(batch["points"])
    logits = state.model(xyz, features, train=False)
    loss, acc = ce_and_accuracy(logits, batch["labels"])
    return {"loss": loss, "accuracy": acc}
