#!/usr/bin/env python
"""Train and test PWCLO-Net with the PyTorch + CUDA port (the counterpart of
``train_net.py`` for ``model=pwclonet``).

Usage::

    # train on KITTI 00-06, eval 07-10
    python train_net_torch.py --do_train --dataset kitti --root_dir /data/kitti \
        --train_sequences 0,1,2,3,4,5,6 --eval_sequences 7,8,9,10 \
        --num_epochs 120 --batch_size 8 --log_dir ./train_out

    # smoke-train on random-cloud pairs (no dataset needed)
    python train_net_torch.py --do_train --dataset synthetic --num_epochs 2 \
        --batch_size 2 --num_points 256 --log_dir ./train_out

    # test: odometry over sequences with the latest checkpoint of log_dir
    python train_net_torch.py --do_test --dataset kitti --root_dir /data/kitti \
        --test_sequences 9,10 --log_dir ./train_out

Options are ``--key value`` (a bare ``--flag`` means true) or the
``key=value`` / ``config=<yaml>`` form of ``train_net.py``. Everything runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.data.kitti import KittiPairDataset, KittiSequence
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.evaluation.metrics import metrics_dict
from pwclonet_pylidarslam_torch.models import scaled_model_config
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
from pwclonet_pylidarslam_torch.train.state import TrainConfig
from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig
from pwclonet_pylidarslam_torch.utils.config import dump_config, parse_cli

# what train_net.py offers and this entry does not yet, with the ROADMAP item that owns it
NOT_PORTED = {
    "model": {
        "posenet": "PoseNet training and odometry: ROADMAP Queue A 7",
        "cls": "classification training: ROADMAP Queue A 8",
        "semseg": "segmentation training: ROADMAP Queue A 8",
    },
    "dataset": {
        "synthetic_world": "the kitti world and kitti_preset of data/synthetic.py: ROADMAP Queue A 9",
        "kitti360": "data/other_datasets.py: ROADMAP Queue A 9",
        "modelnet40": "classification data: ROADMAP Queue A 8",
        "indoor3d": "segmentation data: ROADMAP Queue A 8",
    },
}


@dataclasses.dataclass
class Config:
    do_train: bool = False
    do_test: bool = False
    model: str = "pwclonet"
    dataset: str = "synthetic"  # synthetic | kitti
    root_dir: str = ""
    train_sequences: str = "0,1,2,3,4,5,6"
    eval_sequences: str = "7,8,9,10"
    test_sequences: str = "9,10"
    num_epochs: int = 120
    batch_size: int = 8
    num_points: int = 8192
    learning_rate: float = 1e-3
    log_dir: str = "./train_output"
    augment: bool = True
    seed: int = 0
    synthetic_batches: int = 8  # dataset=synthetic: random-cloud batches per epoch
    fused_eval: bool = False  # test mode: the fused eval kernels
    device: str = "cuda"


def _seqs(s) -> List[int]:
    return [int(x) for x in str(s).strip("[]").split(",") if x != ""]


def _check_ported(config: Config) -> None:
    for field, missing in NOT_PORTED.items():
        value = getattr(config, field)
        if value in missing:
            raise NotImplementedError(f"{field}={value} is not ported yet ({missing[value]})")
    if config.model != "pwclonet" or config.dataset not in ("synthetic", "kitti"):
        raise ValueError(f"unknown model/dataset {config.model!r}/{config.dataset!r}")


def make_batch_fns(config: Config):
    """``(train_batches_fn, eval_batches_fn)``, each returning a fresh batch
    iterator per epoch."""
    if config.dataset == "synthetic":

        def gen(seed):
            r = np.random.default_rng(seed)
            out = []
            for _ in range(config.synthetic_batches):
                pts1 = r.normal(size=(config.batch_size, config.num_points, 3)).astype(np.float32) * 8
                tw = (r.normal(size=(config.batch_size, 6)) * 0.05).astype(np.float32)
                pose = se3.exp(torch.from_numpy(tw))
                pts2 = se3.transform(pose, torch.from_numpy(pts1)).numpy()
                gt = se3.pose_to_params_quat(pose).numpy().astype(np.float32)
                out.append({"xyz1": pts1, "xyz2": pts2, "gt_params": gt})
            return out

        train_data = gen(config.seed)
        eval_data = gen(config.seed + 1)
        return (lambda: iter(train_data)), (lambda: iter(eval_data))

    train_ds = KittiPairDataset(
        config.root_dir, _seqs(config.train_sequences),
        num_points=config.num_points, augment=config.augment, seed=config.seed,
    )
    eval_ds = KittiPairDataset(
        config.root_dir, _seqs(config.eval_sequences),
        num_points=config.num_points, augment=False, seed=config.seed + 1,
    )
    return (
        lambda: train_ds.batches(config.batch_size, shuffle=True),
        lambda: eval_ds.batches(config.batch_size, shuffle=False),
    )


class _SyntheticTestSequence:
    """A 16-frame corridor sequence from the port's generator."""

    def __init__(self, seed: int, num_points: int):
        self.scans, self.poses = generate_sequence(
            SyntheticSequenceConfig(n_frames=16, seed=seed, num_points=num_points))

    def __len__(self):
        return len(self.scans)

    def scan(self, i):
        return self.scans[i]

    def ground_truth(self):
        return self.poses


def make_test_sequence(config: Config, s: int):
    if config.dataset == "synthetic":
        return _SyntheticTestSequence(s, config.num_points)
    return KittiSequence(config.root_dir, s)


def _trainer(config: Config, fused_eval: bool = False, **kw) -> PWCLONetTrainer:
    model_cfg = scaled_model_config(config.num_points, fused_eval=fused_eval)
    train_cfg = TrainConfig(model=model_cfg, learning_rate=config.learning_rate)
    return PWCLONetTrainer(
        TrainerConfig(train=train_cfg, log_dir=config.log_dir, seed=config.seed, **kw),
        device=config.device,
    )


def run_train(config: Config) -> int:
    trainer = _trainer(config, num_epochs=config.num_epochs)
    dump_config(config, f"{config.log_dir}/config.yaml")
    train_fn, eval_fn = make_batch_fns(config)
    history = trainer.fit(train_fn, eval_fn)
    last = history[-1]
    print(
        f"done: epoch {last['epoch']} train_loss={last['train_loss']:.4f} "
        f"eval_loss={last.get('eval_loss', float('nan')):.4f}"
    )
    return 0


def run_test(config: Config) -> int:
    """PWCLO-Net odometry over the test sequences with the latest checkpoint
    of ``log_dir``; prints the KITTI segment error and the ATE per sequence.
    (The result files of ``train_net.py``'s test mode are written by
    ``evaluation/results.py``, which is ROADMAP Queue A 5.)"""
    trainer = _trainer(config, fused_eval=config.fused_eval)
    trainer.load_checkpoint()
    odo = PWCLONetOdometry(
        trainer.state.state_dict(),
        DeepOdometryConfig(model=trainer.config.train.model, num_points=config.num_points),
        device=config.device,
    )
    for s in _seqs(config.test_sequences):
        seq = make_test_sequence(config, s)
        odo.init()
        for i in range(len(seq)):
            odo.process_next_frame(seq.scan(i))
        gt = seq.ground_truth()
        if gt is not None:
            md = metrics_dict(odo.absolute_poses(), gt)
            print(f"seq {s:02d}: t_rel={md['tr_err']:.4f}% ATE={md['ATE']:.4f}")
    return 0


def _key_value_args(argv: List[str]) -> List[str]:
    """``--key value`` and bare ``--flag`` → the ``key=value`` form of ``parse_cli``."""
    out, i = [], 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--") and "=" not in arg:
            if i + 1 < len(argv) and not argv[i + 1].startswith("--") and "=" not in argv[i + 1]:
                out.append(f"{arg[2:]}={argv[i + 1]}")
                i += 1
            else:
                out.append(f"{arg[2:]}=true")
        else:
            out.append(arg[2:] if arg.startswith("--") else arg)
        i += 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    config = parse_cli(Config, _key_value_args(argv))
    _check_ported(config)
    os.makedirs(config.log_dir, exist_ok=True)
    if config.do_train:
        return run_train(config)
    if config.do_test:
        return run_test(config)
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
