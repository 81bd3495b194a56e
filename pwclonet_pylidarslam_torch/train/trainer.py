"""Trainers: epoch loop, eval, checkpointing, in-training metrics.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/trainer.py`` on the
train state of ``train/state.py``:

- ``BaseTrainer``: epoch loop with train and eval phases and average
  meters; steps with a non-finite loss are skipped on the device and counted
  when a block's logs are read; checkpoints (periodic, best-train, best-eval
  and final) written with ``torch.save`` under ``log_dir/checkpoints/``,
  holding the whole train state and the counters; optional TensorBoard and
  wandb logging, both import-gated;
- in-training KITTI-style metrics: the eval predictions are chained into
  trajectories and scored with the segment metric;
- ``PWCLONetTrainer``: the BatchNorm-momentum and learning-rate schedules
  are driven by the step inside ``train_step``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation import metrics as metrics_mod
from pwclonet_pylidarslam_torch.train.state import (
    TrainConfig,
    create_train_state,
    eval_step,
    train_steps,
)
from pwclonet_pylidarslam_torch.utils.timer import span


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    num_epochs: int = 120
    # train steps issued before the host reads their losses back: the only
    # point where the host waits for the device during an epoch
    steps_per_dispatch: int = 16
    log_dir: str = "./train_output"
    checkpoint_every_epochs: int = 10  # periodic checkpoints
    eval_every_epochs: int = 1
    seed: int = 0
    tensorboard: bool = False  # per-epoch scalars via torch.utils.tensorboard
    # optional wandb run: import-gated, the trainer falls back to
    # history.jsonl and TensorBoard when the package is absent
    wandb: bool = False
    wandb_project: str = "pwclonet-pylidarslam-torch"
    wandb_run_name: str = ""


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n

    @property
    def average(self) -> float:
        return self.sum / max(self.count, 1)


_CHECKPOINT = re.compile(r"step_(\d+)\.pt$")


class BaseTrainer:
    """Shared plumbing for the deep-odometry trainers.

    Subclasses set ``self.state`` and implement ``_train_steps(block)``
    (K steps from a stacked block, returning stacked logs), ``_eval_step(
    batch)`` and ``_relative_poses(pred, batch)``, which maps an eval-step
    prediction to ``(pred_rel, gt_rel)`` 4×4 matrices for the KITTI
    in-training metrics.
    """

    def __init__(self, config):
        self.config = config
        os.makedirs(config.log_dir, exist_ok=True)
        self.epoch = 0
        self.best_train_loss = float("inf")
        self.best_eval_loss = float("inf")
        self.history: List[Dict] = []
        # the per-step logs of the last train epoch, {key: (steps,) array}
        self.last_epoch_logs: Dict[str, np.ndarray] = {}
        self._tb = None
        if config.tensorboard:
            try:  # optional dependency
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(config.log_dir, "tb"))
            except ImportError as exc:
                print(f"[trainer] tensorboard unavailable: {exc}")
        self._wandb = None
        if config.wandb:
            try:  # optional dependency
                import wandb

                self._wandb = wandb.init(
                    project=config.wandb_project,
                    name=config.wandb_run_name or None,
                    dir=config.log_dir,
                    config=dataclasses.asdict(config),
                )
            except ImportError as exc:
                print(f"[trainer] wandb unavailable: {exc}")

    # -- hooks ---------------------------------------------------------------

    def _train_steps(self, block: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _eval_step(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def _relative_poses(self, pred, batch: Dict) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    @staticmethod
    def _batch_size(batch: Dict) -> int:
        return int(next(iter(batch.values())).shape[0])

    # -- checkpointing ---------------------------------------------------------

    def _checkpoint_dir(self) -> str:
        return os.path.join(os.path.abspath(self.config.log_dir), "checkpoints")

    def checkpoint_steps(self) -> List[int]:
        """The steps that have a checkpoint, ascending."""
        if not os.path.isdir(self._checkpoint_dir()):
            return []
        found = (_CHECKPOINT.match(name) for name in os.listdir(self._checkpoint_dir()))
        return sorted(int(m.group(1)) for m in found if m)

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self._checkpoint_dir(), f"step_{step:08d}.pt")

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """Write the train state and the counters as the checkpoint of the
        current step (a second save at one step replaces the first)."""
        os.makedirs(self._checkpoint_dir(), exist_ok=True)
        path = self.checkpoint_path(self.state.step)
        payload = self.state.state_dict()
        payload["meta"] = {
            "epoch": self.epoch,
            "best_train_loss": self.best_train_loss,
            "best_eval_loss": self.best_eval_loss,
            "tag": tag or "periodic",
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def load_checkpoint(self, step: Optional[int] = None) -> None:
        """Restore the train state and the counters from the checkpoint of
        ``step``, the latest when None."""
        if step is None:
            steps = self.checkpoint_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {self._checkpoint_dir()}")
            step = steps[-1]
        payload = torch.load(self.checkpoint_path(step), map_location=self.state.device,
                             weights_only=True)
        self.state.load_state_dict(payload)
        meta = payload["meta"]
        self.epoch = meta["epoch"]
        self.best_train_loss = meta["best_train_loss"]
        self.best_eval_loss = meta["best_eval_loss"]

    # -- epoch loops -------------------------------------------------------------

    def train_epoch(self, batches: Iterable[Dict]) -> float:
        """Train over ``batches`` in blocks of ``steps_per_dispatch`` steps;
        a change of batch size or the epoch's tail ends a block early. The
        logs of a block are read back once, after its last step, and kept in
        ``last_epoch_logs``."""
        meter = AverageMeter()
        skipped = 0
        k = max(1, self.config.steps_per_dispatch)
        epoch_logs: List[Dict[str, np.ndarray]] = []

        def flush(block: List[Dict]):
            nonlocal skipped
            if not block:
                return
            with span("train.block"):
                with span("train.stack"):
                    stacked = {key: np.stack([np.asarray(b[key]) for b in block])
                               for key in block[0]}
                out = self._train_steps(stacked)
                with span("train.readback"):  # the block's one wait for the device
                    logs = {key: v.cpu().numpy() for key, v in out.items()}
            epoch_logs.append(logs)
            for loss in logs["loss"]:
                if np.isfinite(loss):
                    meter.update(float(loss), n=self._batch_size(block[0]))
                else:
                    skipped += 1

        block: List[Dict] = []
        for batch in batches:
            if block and (len(block) == k
                          or self._batch_size(batch) != self._batch_size(block[0])):
                flush(block)
                block = []
            block.append(batch)
        flush(block)
        self.last_epoch_logs = {
            key: np.concatenate([logs[key] for logs in epoch_logs])
            for key in (epoch_logs[0] if epoch_logs else {})
        }
        if skipped:
            print(f"[trainer] skipped {skipped} non-finite batches this epoch")
        return meter.average

    def evaluate_epoch(self, batches: Iterable[Dict]) -> Dict[str, float]:
        meter = AverageMeter()
        rel_pred, rel_gt = [], []
        for batch in batches:
            pred, log = self._eval_step(batch)
            meter.update(float(log["loss"]), n=self._batch_size(batch))
            rel = self._relative_poses(pred, batch)
            if rel is not None:
                rel_pred.append(rel[0])
                rel_gt.append(rel[1])
        out = {"eval_loss": meter.average}
        if rel_pred:
            rp = np.concatenate(rel_pred)
            rg = np.concatenate(rel_gt)
            ate, std_ate = metrics_mod.compute_ate(rp, rg)
            are, std_are = metrics_mod.compute_are(rp, rg)
            # chain into trajectories for the KITTI segment metric
            traj_p = metrics_mod.compute_absolute_poses(rp)
            traj_g = metrics_mod.compute_absolute_poses(rg)
            tr, rot, _ = metrics_mod.compute_kitti_metrics(traj_p, traj_g)
            out.update(
                ATE=ate, STD_ATE=std_ate, ARE=are, STD_ARE=std_are,
                tr_err=100.0 * tr if tr is not None else float("nan"),
                rot_err=float(np.rad2deg(rot) * 100) if rot is not None else float("nan"),
            )
        return out

    def fit(self, train_batches_fn, eval_batches_fn=None,
            num_epochs: Optional[int] = None) -> List[Dict]:
        """Full training run. ``train_batches_fn()`` returns a fresh batch
        iterator per epoch (host-side dataset shuffling included)."""
        num_epochs = num_epochs or self.config.num_epochs
        for _ in range(num_epochs):
            t0 = time.time()
            train_loss = self.train_epoch(train_batches_fn())
            record = {
                "epoch": self.epoch,
                "train_loss": train_loss,
                "seconds": time.time() - t0,
            }
            if train_loss < self.best_train_loss:
                self.best_train_loss = train_loss
                self.save_checkpoint("best_train")
            if eval_batches_fn is not None and self.epoch % self.config.eval_every_epochs == 0:
                record.update(self.evaluate_epoch(eval_batches_fn()))
                if record["eval_loss"] < self.best_eval_loss:
                    self.best_eval_loss = record["eval_loss"]
                    self.save_checkpoint("best_eval")
            if (self.config.checkpoint_every_epochs
                    and self.epoch % self.config.checkpoint_every_epochs == 0):
                self.save_checkpoint("periodic")
            self.history.append(record)
            with open(os.path.join(self.config.log_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
            scalars = {k: v for k, v in record.items()
                       if isinstance(v, (int, float)) and np.isfinite(v)}
            if self._tb is not None:
                for k, v in scalars.items():
                    self._tb.add_scalar(k, v, self.epoch)
            if self._wandb is not None:
                self._wandb.log(scalars, step=self.epoch)
            self.epoch += 1
        self.save_checkpoint("final")
        if self._wandb is not None:
            self._wandb.finish()
        return self.history


class PWCLONetTrainer(BaseTrainer):
    """Trains PWCLO-Net on ``device``: CUDA unless the caller asks for the CPU."""

    def __init__(self, config: Optional[TrainerConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(config or TrainerConfig())
        self.device = resolve_device(device)
        self.state = create_train_state(self.config.train, seed=self.config.seed,
                                        device=self.device)

    @property
    def model(self):
        return self.state.model

    def _train_steps(self, block):
        return train_steps(self.config.train, self.state, block)

    def _eval_step(self, batch):
        return eval_step(self.config.train, self.state, batch)

    def _relative_poses(self, pred, batch):
        # finest level params -> relative pose matrices
        gt = torch.as_tensor(batch["gt_params"])
        return (
            se3.params_to_pose_quat(pred[:, 0, :]).cpu().numpy(),
            se3.params_to_pose_quat(gt).cpu().numpy(),
        )
