"""Train state and train/eval steps for PoseResNet odometry.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/posenet_state.py``:

- the supervised pose-regression loss or the unsupervised point-to-plane
  loss (``loss``);
- Adam, or AdamW (decoupled decay on every tensor) when ``weight_decay >
  0``, over the network and, when supervised with exponential weighting,
  the learned loss weights: ``train/state.py``'s :class:`Adam` with the
  schedule below;
- the learning rate is piecewise constant: ``learning_rate`` times
  ``lr_gamma`` for each milestone the count of applied updates has reached;
- the step whose loss is not finite changes nothing but the step counter,
  decided on the device as in ``train/state.py``.

The convolutions and products run in full fp32 with cuDNN's deterministic
algorithms (``models.posenet.conv_precision``), so that two equal steps
give equal gradients; ``tf32=True`` lets them run in TF32.

Batch contract: ``{"vm1": (B, H, W, 3) current/target vertex map, "vm2":
(B, H, W, 3) previous/reference vertex map, "gt_pose": (B, 4, 4)}`` with
``gt_pose`` mapping current coordinates into previous ones, or the window
batches ``{"frames": (B, S, H, W, 3) newest first, "gt_poses": (B, S-1, 4,
4)}`` of ``data/vm_pairs.py``; numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Tuple, Union

import torch

from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.models.layers import commit_batch_stats
from pwclonet_pylidarslam_torch.models.posenet import PoseResNet, PoseResNetConfig, conv_precision
from pwclonet_pylidarslam_torch.train.posenet_losses import (
    PointToPlaneLossConfig,
    SupervisedLossConfig,
    init_supervised_loss_params,
    point_to_plane_loss,
    pose_supervision_loss,
)
from pwclonet_pylidarslam_torch.train.state import TrainState, _to_device, _unstack


@dataclasses.dataclass(frozen=True)
class PoseNetTrainConfig:
    model: PoseResNetConfig = PoseResNetConfig()
    loss: str = "supervised"  # supervised | unsupervised
    supervised: SupervisedLossConfig = SupervisedLossConfig()
    unsupervised: PointToPlaneLossConfig = PointToPlaneLossConfig()
    projector: SphericalProjector = SphericalProjector()  # unsupervised re-projection
    learning_rate: float = 1e-4
    lr_milestones: Tuple[int, ...] = (20_000, 40_000)  # updates
    lr_gamma: float = 0.5
    weight_decay: float = 0.0
    tf32: bool = False  # TF32 convolutions and products (not the reference's fp32)


def learning_rate(config: PoseNetTrainConfig, count: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate of update number ``count`` (0 for the first), as a
    float64 0-dim tensor on ``count``'s device."""
    c = torch.as_tensor(count).to(torch.float64)
    lr = torch.full_like(c, config.learning_rate)
    for milestone in config.lr_milestones:
        lr = torch.where(c >= milestone, lr * config.lr_gamma, lr)
    return lr


def create_posenet_train_state(config: PoseNetTrainConfig, seed: int = 0,
                               device: Union[str, torch.device] = "cuda") -> TrainState:
    """A seeded PoseResNet on ``device`` (CUDA unless the caller asks for
    the CPU), its loss parameters and a fresh optimizer."""
    if config.model.num_out_poses != config.model.sequence_len - 1:
        raise ValueError(
            "windowed training regresses one pose per consecutive frame pair: "
            f"num_out_poses must be sequence_len-1, got {config.model.num_out_poses} "
            f"vs sequence_len={config.model.sequence_len}")
    model = PoseResNet(config.model, seed=seed, device=device)
    dev = next(model.parameters()).device
    loss_params = (init_supervised_loss_params(config.supervised, dev)
                   if config.loss == "supervised" and config.supervised.with_exp_weights else {})
    return TrainState(model, loss_params, config,
                      schedule=functools.partial(learning_rate, config))


def _stack_frames(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``(B, S, H, W, 3)``: the window batch's frames, or a pair stacked
    current first."""
    if "frames" in batch:
        return batch["frames"]
    return torch.stack([batch["vm1"], batch["vm2"]], dim=1)


def _gt_poses(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``(B, P, 4, 4)``: one ground-truth relative pose per frame pair."""
    if "gt_poses" in batch:
        return batch["gt_poses"]
    return batch["gt_pose"][:, None]


def _loss_and_log(config: PoseNetTrainConfig, loss_params: Dict[str, torch.Tensor],
                  pred: torch.Tensor, batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``pred (B, P, 6)``: one (t, euler) per consecutive frame pair."""
    b, p = pred.shape[:2]
    if config.loss == "supervised":
        # the pose axis folded into the batch: the loss averages over it
        gt = _gt_poses(batch).to(pred.dtype)
        return pose_supervision_loss(loss_params, pred.reshape(b * p, 6),
                                     gt.reshape(b * p, 4, 4), config.supervised)
    frames = _stack_frames(batch)
    # frames[:, k] is the target (current), frames[:, k+1] its reference
    loss = torch.mean(torch.stack([
        point_to_plane_loss(config.projector, frames[:, k], frames[:, k + 1], pred[:, k],
                            config=config.unsupervised)
        for k in range(p)
    ]))
    return loss, {"loss": loss}


def posenet_loss_and_grads(config: PoseNetTrainConfig, state: TrainState, batch: Mapping
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Train-mode forward, loss and backward: ``(loss, log, grads)`` with
    ``grads`` keyed as :meth:`TrainState.trainable`. The new running
    statistics are left pending on the model; nothing else changes."""
    batch = _to_device(batch, state.device)
    with conv_precision(config.tf32):
        pred = state.model(_stack_frames(batch), train=True)
        loss, log = _loss_and_log(config, state.loss_params, pred, batch)
        named = state.trainable()
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(named.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in log.items()}, grads


def posenet_train_step(config: PoseNetTrainConfig, state: TrainState, batch: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``state``, in place. Returns the log, 0-dim
    tensors on the device: the loss terms, ``grad_norm`` and
    ``skipped_nonfinite``."""
    loss, log, grads = posenet_loss_and_grads(config, state, batch)
    finite = torch.isfinite(loss)
    flat_grad = state.optimizer.update(list(grads.values()), apply=finite)
    commit_batch_stats(state.model, keep=finite)
    state.step += 1
    log["grad_norm"] = torch.linalg.vector_norm(flat_grad)
    log["skipped_nonfinite"] = torch.logical_not(finite)
    return log


def posenet_train_steps(config: PoseNetTrainConfig, state: TrainState,
                        batch_block: Mapping) -> Dict[str, torch.Tensor]:
    """K train steps from one block of ``(K, B, ...)`` arrays. Returns the
    logs stacked ``(K,)``; no step waits for the host."""
    logs = [posenet_train_step(config, state, batch) for batch in _unstack(batch_block)]
    return {key: torch.stack([log[key] for log in logs]) for key in logs[0]}


@torch.no_grad()
def posenet_eval_step(config: PoseNetTrainConfig, state: TrainState, batch: Mapping
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and loss with the running statistics. Returns the ``(B, P,
    6)`` predictions and the log."""
    batch = _to_device(batch, state.device)
    with conv_precision(config.tf32):
        pred = state.model(_stack_frames(batch), train=False)
        _, log = _loss_and_log(config, state.loss_params, pred, batch)
    return pred, log
