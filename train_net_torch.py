#!/usr/bin/env python
"""Train and test PWCLO-Net or PoseResNet with the PyTorch + CUDA port (the
counterpart of ``train_net.py`` for ``model=pwclonet|posenet``).

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

    # PoseResNet on 64x720 vertex-map pairs (config/train_posenet.yaml)
    python train_net_torch.py config=train_posenet do_train=true root_dir=/data/kitti \
        log_dir=./posenet_out

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
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.data.kitti import KittiPairDataset, KittiSequence
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.data.vm_pairs import (
    MultiSequenceWindowDataset,
    VertexMapPairDataset,
    VertexMapWindowDataset,
    concat_pair_datasets,
)
from pwclonet_pylidarslam_torch.evaluation.results import OdometryResults, write_devkit_report
from pwclonet_pylidarslam_torch.models import scaled_model_config
from pwclonet_pylidarslam_torch.models.posenet import PoseResNetConfig
from pwclonet_pylidarslam_torch.slam.deep_odometry import (
    DeepOdometryConfig,
    PoseNetOdometry,
    PoseNetOdometryConfig,
    PWCLONetOdometry,
)
from pwclonet_pylidarslam_torch.train.posenet_state import PoseNetTrainConfig
from pwclonet_pylidarslam_torch.train.posenet_trainer import PoseNetTrainer, PoseNetTrainerConfig
from pwclonet_pylidarslam_torch.train.state import TrainConfig
from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig
from pwclonet_pylidarslam_torch.utils.config import dump_config, parse_cli

# what train_net.py offers and this entry does not yet, with the ROADMAP item that owns it
NOT_PORTED = {
    "model": {
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
    posenet_loss: str = "supervised"  # model=posenet: supervised | unsupervised
    # model=posenet: frames a window (2: pairs; more: one pose per pair)
    sequence_len: int = 2
    vm_height: int = 64
    vm_width: int = 720
    device: str = "cuda"


def _seqs(s) -> List[int]:
    return [int(x) for x in str(s).strip("[]").split(",") if x != ""]


def _check_ported(config: Config) -> None:
    for field, missing in NOT_PORTED.items():
        value = getattr(config, field)
        if value in missing:
            raise NotImplementedError(f"{field}={value} is not ported yet ({missing[value]})")
    if config.model not in ("pwclonet", "posenet") or config.dataset not in ("synthetic", "kitti"):
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


def make_posenet_batch_fns(config: Config, projector: SphericalProjector):
    """Vertex-map pair batches (``sequence_len`` 2) or window batches
    (``sequence_len`` > 2): ``(train_batches_fn, eval_batches_fn)``."""
    windowed = config.sequence_len > 2

    def make_ds(scans, gt, num_points=65536):
        if windowed:
            return VertexMapWindowDataset.from_scans(
                scans, gt, projector, num_points=num_points, sequence_len=config.sequence_len,
                device=config.device)
        return VertexMapPairDataset.from_scans(scans, gt, projector, num_points=num_points,
                                               device=config.device)

    def from_sequences(seq_ids, seed):
        datasets = []
        if config.dataset == "synthetic":
            scans, gt = generate_sequence(
                SyntheticSequenceConfig(n_frames=16 + 2 * config.synthetic_batches, seed=seed))
            datasets.append(make_ds(scans, gt, num_points=scans.shape[1]))
        else:
            for s in seq_ids:
                seq = KittiSequence(config.root_dir, s)
                datasets.append(make_ds([seq.scan(i) for i in range(len(seq))],
                                        seq.ground_truth()))
        if windowed:
            return MultiSequenceWindowDataset(datasets)
        return concat_pair_datasets(datasets)

    train_ds = from_sequences(_seqs(config.train_sequences), config.seed)
    eval_ds = from_sequences(_seqs(config.eval_sequences), config.seed + 1)
    epoch = [0]

    def train_fn():
        epoch[0] += 1
        return train_ds.batches(config.batch_size, shuffle=True, seed=epoch[0])

    return train_fn, (lambda: eval_ds.batches(config.batch_size, shuffle=False))


def _projector(config: Config) -> SphericalProjector:
    return SphericalProjector(height=config.vm_height, width=config.vm_width)


def run_train_posenet(config: Config) -> int:
    projector = _projector(config)
    trainer = PoseNetTrainer(
        PoseNetTrainerConfig(
            train=PoseNetTrainConfig(
                model=PoseResNetConfig(sequence_len=config.sequence_len,
                                       num_out_poses=config.sequence_len - 1),
                loss=config.posenet_loss, projector=projector,
                learning_rate=config.learning_rate,
            ),
            vm_shape=(config.vm_height, config.vm_width), num_epochs=config.num_epochs,
            log_dir=config.log_dir, seed=config.seed,
        ),
        device=config.device,
    )
    dump_config(config, f"{config.log_dir}/config.yaml")
    history = trainer.fit(*make_posenet_batch_fns(config, projector))
    _print_done(history)
    return 0


def _print_done(history) -> None:
    last = history[-1]
    print(
        f"done: epoch {last['epoch']} train_loss={last['train_loss']:.4f} "
        f"eval_loss={last.get('eval_loss', float('nan')):.4f}"
    )


def _test_sequences(config: Config, odo) -> None:
    """Odometry over the test sequences, as ``train_net.py``'s test mode:
    per sequence the pose files and ``metrics.yaml`` of ``OdometryResults``
    under ``<log_dir>/test`` and the devkit report under
    ``<log_dir>/test/<seq>_eval``; prints the KITTI segment error and the
    ATE."""
    results = OdometryResults(f"{config.log_dir}/test")
    for s in _seqs(config.test_sequences):
        seq = make_test_sequence(config, s)
        odo.init()
        for i in range(len(seq)):
            odo.process_next_frame(seq.scan(i))
        md = results.add_sequence(f"{s:02d}", odo.absolute_poses(), seq.ground_truth())
        write_devkit_report(
            f"{config.log_dir}/test/{s:02d}_eval", f"{s:02d}",
            odo.absolute_poses(), seq.ground_truth(),
        )
        if md:
            print(f"seq {s:02d}: t_rel={md['tr_err']:.4f}% ATE={md['ATE']:.4f}")


def run_test_posenet(config: Config) -> int:
    """PoseResNet odometry over the test sequences with the latest
    checkpoint of ``log_dir``."""
    projector = _projector(config)
    trainer = PoseNetTrainer(
        PoseNetTrainerConfig(train=PoseNetTrainConfig(projector=projector),
                             vm_shape=(config.vm_height, config.vm_width),
                             log_dir=config.log_dir),
        device=config.device,
    )
    trainer.load_checkpoint()
    odo = PoseNetOdometry(trainer.odometry_variables(), PoseNetOdometryConfig(projector=projector),
                          device=config.device)
    _test_sequences(config, odo)
    return 0


def run_train(config: Config) -> int:
    if config.model == "posenet":
        return run_train_posenet(config)
    trainer = _trainer(config, num_epochs=config.num_epochs)
    dump_config(config, f"{config.log_dir}/config.yaml")
    train_fn, eval_fn = make_batch_fns(config)
    _print_done(trainer.fit(train_fn, eval_fn))
    return 0


def run_test(config: Config) -> int:
    """PWCLO-Net (or, ``model=posenet``, PoseResNet) odometry over the test
    sequences with the latest checkpoint of ``log_dir``."""
    if config.model == "posenet":
        return run_test_posenet(config)
    trainer = _trainer(config, fused_eval=config.fused_eval)
    trainer.load_checkpoint()
    odo = PWCLONetOdometry(
        trainer.state.state_dict(),
        DeepOdometryConfig(model=trainer.config.train.model, num_points=config.num_points),
        device=config.device,
    )
    _test_sequences(config, odo)
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
