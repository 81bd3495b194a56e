"""PoseResNet trainer.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/posenet_trainer.py``:
``train/trainer.py``'s ``BaseTrainer`` (epoch loop, checkpoints in the
port's ``torch.save`` format, in-training KITTI segment metrics) over the
PoseResNet train state of ``train/posenet_state.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.train.posenet_state import (
    PoseNetTrainConfig,
    create_posenet_train_state,
    posenet_eval_step,
    posenet_train_steps,
)
from pwclonet_pylidarslam_torch.train.trainer import BaseTrainer


@dataclasses.dataclass
class PoseNetTrainerConfig:
    train: PoseNetTrainConfig = dataclasses.field(default_factory=PoseNetTrainConfig)
    # the vertex-map grid (KITTI HDL-64), as in the reference's config; the
    # network takes any grid, so nothing here is sized from it
    vm_shape: Tuple[int, int] = (64, 720)
    num_epochs: int = 100
    steps_per_dispatch: int = 16  # train steps between host reads of the losses
    log_dir: str = "./posenet_train_output"
    checkpoint_every_epochs: int = 10
    eval_every_epochs: int = 1
    seed: int = 0
    tensorboard: bool = False
    wandb: bool = False
    wandb_project: str = "pwclonet-pylidarslam-torch"
    wandb_run_name: str = ""


class PoseNetTrainer(BaseTrainer):
    """Trains PoseResNet on ``device``: CUDA unless the caller asks for the CPU."""

    def __init__(self, config: Optional[PoseNetTrainerConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(config or PoseNetTrainerConfig())
        self.device = resolve_device(device)
        self.state = create_posenet_train_state(self.config.train, seed=self.config.seed,
                                                device=self.device)

    @property
    def model(self):
        return self.state.model

    def _train_steps(self, block):
        return posenet_train_steps(self.config.train, self.state, block)

    def _eval_step(self, batch):
        return posenet_eval_step(self.config.train, self.state, batch)

    def _relative_poses(self, pred, batch):
        if "gt_pose" not in batch and "gt_poses" not in batch:
            return None  # unsupervised eval has no ground truth
        b, p = pred.shape[:2]  # one relative pose per consecutive window pair
        gt = batch["gt_poses"] if "gt_poses" in batch else np.asarray(batch["gt_pose"])[:, None]
        return (se3.params_to_pose_euler(pred.reshape(b * p, 6)).cpu().numpy(),
                np.asarray(gt).reshape(b * p, 4, 4))

    def odometry_variables(self) -> dict:
        """What ``slam.deep_odometry.PoseNetOdometry`` loads: ``{"model":
        the network's state dict}``."""
        return {"model": {k: v.clone() for k, v in self.state.model.state_dict().items()}}
