"""Train state and train/eval steps for PWCLO-Net.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/state.py``:

- one :class:`TrainState` object: the network (parameters and running
  BatchNorm statistics), the loss parameters (learned exponential weights),
  the optimizer, the step counter and the dropout generator. The steps below
  update it in place;
- Adam (AdamW with ``weight_decay``) over network and loss parameters
  jointly;
- cosine learning rate ``learning_rate → lr_min`` over ``total_steps``,
  after a linear warmup from ``0.01·learning_rate`` when ``warmup_steps > 0``;
- BatchNorm momentum ``0.5 → 0.01``, halved every ``bn_decay_steps`` steps.

A step whose loss is not finite changes nothing but the step counter:
parameters, running statistics, loss parameters and optimizer state keep
their values to the bit. The check stays on the device (``torch.where`` on
the update, the moments, the update count and the statistics), so a step
never waits for the host; the learning rate is computed on the device from
the optimizer's count of applied updates for the same reason.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig
from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats
from pwclonet_pylidarslam_torch.train.losses import (
    PWCLONetLossConfig,
    init_loss_params,
    pwclonet_loss,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: PWCLONetConfig = PWCLONetConfig()
    loss: PWCLONetLossConfig = PWCLONetLossConfig()
    learning_rate: float = 1e-3
    lr_min: float = 1e-6
    total_steps: int = 100_000  # for the cosine schedule
    # linear warmup to learning_rate over this many steps (0 = plain cosine)
    warmup_steps: int = 0
    weight_decay: float = 0.0
    bn_momentum_init: float = 0.5
    bn_momentum_decay: float = 0.5
    bn_decay_steps: int = 10_000  # steps between BN momentum halvings
    bn_momentum_min: float = 0.01


def learning_rate(config: TrainConfig, count: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate of update number ``count`` (0 for the first), as a
    float64 0-dim tensor on ``count``'s device."""
    c = torch.as_tensor(count).to(torch.float64)
    peak = config.learning_rate
    alpha = config.lr_min / peak

    def cosine(c: torch.Tensor, steps: int) -> torch.Tensor:
        c = torch.clamp(c, max=steps)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * c / steps)) + alpha)

    warmup = config.warmup_steps
    if warmup <= 0:
        return cosine(c, config.total_steps)
    start = 0.01 * peak
    ramp = (start - peak) * (1.0 - torch.clamp(c, 0, warmup) / warmup) + peak
    return torch.where(c < warmup, ramp, cosine(c - warmup, config.total_steps - warmup))


def bn_momentum(config: TrainConfig, step: int) -> float:
    """BatchNorm momentum (torch convention) at train step ``step``."""
    m = config.bn_momentum_init * config.bn_momentum_decay ** (step // config.bn_decay_steps)
    return max(m, config.bn_momentum_min)


class Adam:
    """Adam, or AdamW when ``config.weight_decay > 0``, over named tensors.

    ``eps`` is added outside the root and the bias corrections use the count
    of applied updates, starting at 1 for the first, as ``torch.optim.Adam``
    does; the learning rate is ``schedule`` (by default
    :func:`learning_rate` of ``config``) of that count before the update.
    AdamW's decay is decoupled, ``lr · weight_decay · p``, on every tensor.
    Both moments live in one flat buffer each, so an update is a handful of
    launches whatever the number of parameters, and one ``torch.where``
    withholds it.
    """

    def __init__(self, named: Mapping[str, torch.Tensor], config,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.config = config
        self.schedule = schedule or functools.partial(learning_rate, config)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.names = list(named)
        self.params = list(named.values())
        self.sizes = [p.numel() for p in self.params]
        device = self.params[0].device
        self.exp_avg = torch.zeros(sum(self.sizes), dtype=torch.float32, device=device)
        self.exp_avg_sq = torch.zeros_like(self.exp_avg)
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view_as(p) for v, p in zip(flat.split(self.sizes), self.params)]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], apply: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """One update of the parameters, in place, from ``grads`` (in the
        order of ``names``). ``apply``: optional 0-dim bool tensor; where it
        is False nothing changes. Returns the flat gradient."""
        g = torch.cat([x.reshape(-1) for x in grads])
        exp_avg = self.b1 * self.exp_avg + (1.0 - self.b1) * g
        exp_avg_sq = self.b2 * self.exp_avg_sq + (1.0 - self.b2) * (g * g)
        count = self.count + 1
        correction1 = (1.0 - self.b1 ** count.to(torch.float64)).to(torch.float32)
        correction2 = (1.0 - self.b2 ** count.to(torch.float64)).to(torch.float32)
        direction = (exp_avg / correction1) / (torch.sqrt(exp_avg_sq / correction2) + self.eps)
        if self.config.weight_decay > 0:
            flat_params = torch.cat([p.reshape(-1) for p in self.params])
            direction = direction + self.config.weight_decay * flat_params
        step = self.schedule(self.count).to(torch.float32) * direction
        if apply is not None:
            step = torch.where(apply, step, torch.zeros_like(step))
            exp_avg = torch.where(apply, exp_avg, self.exp_avg)
            exp_avg_sq = torch.where(apply, exp_avg_sq, self.exp_avg_sq)
            count = torch.where(apply, count, self.count)
        torch._foreach_sub_(self.params, self._views(step))
        self.exp_avg, self.exp_avg_sq, self.count = exp_avg, exp_avg_sq, count
        return g

    def state_dict(self) -> Dict:
        """``{"count", "exp_avg": {name: tensor}, "exp_avg_sq": {...}}``, copies."""
        return {
            "count": self.count.clone(),
            "exp_avg": {n: v.clone() for n, v in zip(self.names, self._views(self.exp_avg))},
            "exp_avg_sq": {n: v.clone() for n, v in zip(self.names, self._views(self.exp_avg_sq))},
        }

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        for key, flat in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq)):
            given = state[key]
            if set(given) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names differ from the parameters': "
                               f"{sorted(set(given) ^ set(self.names))}")
            for name, view in zip(self.names, self._views(flat)):
                if tuple(given[name].shape) != tuple(view.shape):
                    raise ValueError(f"shape mismatch for {key}[{name!r}]: "
                                     f"{tuple(given[name].shape)} vs {tuple(view.shape)}")
                view.copy_(torch.as_tensor(given[name]))
        self.count = torch.as_tensor(state["count"]).to(self.count)


class TrainState:
    """The network, the loss parameters, the optimizer, the count of train
    steps taken and the generator the steps draw their dropout masks from."""

    def __init__(self, model: torch.nn.Module, loss_params: Dict[str, torch.Tensor], config,
                 generator: Optional[torch.Generator] = None,
                 schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.model = model
        self.loss_params = loss_params
        self.optimizer = Adam(self.trainable(), config, schedule=schedule)
        self.step = 0
        self.generator = generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def trainable(self) -> Dict[str, torch.Tensor]:
        """``{"net.<parameter name>": ..., "loss.s_param": ...}``."""
        named = {f"net.{name}": p for name, p in self.model.named_parameters()}
        named.update({f"loss.{name}": p for name, p in self.loss_params.items()})
        return named

    def state_dict(self) -> Dict:
        return {
            "model": {k: v.clone() for k, v in self.model.state_dict().items()},
            "loss_params": {k: v.detach().clone() for k, v in self.loss_params.items()},
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": None if self.generator is None else self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        self.model.load_state_dict(state["model"])
        for name, p in self.loss_params.items():
            p.copy_(state["loss_params"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.generator is not None and state.get("generator") is not None:
            self.generator.set_state(state["generator"].cpu())


def create_train_state(config: TrainConfig, seed: int = 0,
                       device: Union[str, torch.device] = "cuda") -> TrainState:
    """A seeded network on ``device`` (CUDA unless the caller asks for the
    CPU), the initial loss parameters, a fresh optimizer, and a dropout
    generator on that device seeded with ``seed + 1``."""
    model = PWCLONet(config.model, seed=seed, device=device)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model, init_loss_params(config.loss, device), config, generator)


def _to_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(
    config: TrainConfig, state: TrainState, batch: Mapping,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Train-mode forward, loss and backward: ``(loss, log, grads)`` with
    ``grads`` keyed as :meth:`TrainState.trainable`. The new running
    statistics are left pending on the model and the state's generator has
    drawn the dropout masks; nothing else changes."""
    batch = _to_device(batch, state.device)
    pred, _aux = state.model(
        batch["xyz1"], batch["xyz2"], train=True, bn_momentum=bn_momentum(config, state.step),
        generator=state.generator,
    )
    loss, log = pwclonet_loss(state.loss_params, pred, batch["gt_params"], config.loss)
    named = state.trainable()
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(named.items(), grads)}
    return loss.detach(), log, grads


def train_step(config: TrainConfig, state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``state``, in place. ``batch``: ``{"xyz1":
    (B,N,3), "xyz2": (B,N,3), "gt_params": (B,7)}`` (numpy or tensors) with
    gt = (t, q_wxyz) mapping frame 1 into frame 2. Returns the log, 0-dim
    tensors on the device: the loss terms, ``grad_norm`` and
    ``skipped_nonfinite``."""
    loss, log, grads = loss_and_grads(config, state, batch)
    return apply_grads(config, state, loss, log, grads)


def apply_grads(config: TrainConfig, state: TrainState, loss: torch.Tensor,
                log: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The rest of :func:`train_step` after :func:`loss_and_grads`: one Adam
    update from ``grads`` and the pending statistics committed, both only
    where ``loss`` is finite, and the step counted. Returns ``log`` with
    ``grad_norm`` and ``skipped_nonfinite``."""
    finite = torch.isfinite(loss)
    flat_grad = state.optimizer.update(list(grads.values()), apply=finite)
    commit_batch_stats(state.model, keep=finite)
    state.step += 1
    log["grad_norm"] = torch.linalg.vector_norm(flat_grad)
    log["skipped_nonfinite"] = torch.logical_not(finite)
    return log


def _unstack(batch_block: Mapping) -> List[Dict]:
    k = len(next(iter(batch_block.values())))
    return [{key: v[i] for key, v in batch_block.items()} for i in range(k)]


def train_steps(config: TrainConfig, state: TrainState,
                batch_block: Mapping) -> Dict[str, torch.Tensor]:
    """K train steps from one block of ``(K, B, ...)`` arrays, the state's
    generator advanced from step to step. Returns the logs stacked ``(K,)``. No step
    waits for the host, so the caller reads the logs once per block."""
    logs = [train_step(config, state, batch) for batch in _unstack(batch_block)]
    return {key: torch.stack([log[key] for log in logs]) for key in logs[0]}


@torch.no_grad()
def estimate_batch_stats(state: TrainState, batch_block: Mapping) -> None:
    """Re-estimate the running BatchNorm statistics over ``batch_block``
    ``(K, B, ...)`` with frozen weights, in place: each batch is forwarded in
    train mode and folded in with momentum ``1 / (k + 1)``, which leaves the
    arithmetic mean of the per-batch statistics."""
    for k, batch in enumerate(_unstack(batch_block)):
        batch = _to_device(batch, state.device)
        state.model(batch["xyz1"], batch["xyz2"], train=True, bn_momentum=1.0 / (k + 1.0),
                    generator=state.generator)
        commit_batch_stats(state.model)


@torch.no_grad()
def eval_step(
    config: TrainConfig, state: TrainState, batch: Mapping,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + loss with the running statistics and no dropout."""
    batch = _to_device(batch, state.device)
    pred, _aux = state.model(batch["xyz1"], batch["xyz2"], train=False)
    _, log = pwclonet_loss(state.loss_params, pred, batch["gt_params"], config.loss)
    return pred, log

