#!/usr/bin/env python
"""Train and test PWCLO-Net or PoseResNet, and train the PointNet++
classifier or segmenter, with the PyTorch + CUDA port (the counterpart of
``train_net.py``).

Usage::

    # train on KITTI 00-06, eval 07-10
    python train_net_torch.py --do_train --dataset kitti --root_dir /data/kitti \
        --train_sequences 0,1,2,3,4,5,6 --eval_sequences 7,8,9,10 \
        --num_epochs 120 --batch_size 8 --log_dir ./train_out

    # smoke-train on random-cloud pairs (no dataset needed)
    python train_net_torch.py --do_train --dataset synthetic --num_epochs 2 \
        --batch_size 2 --num_points 256 --log_dir ./train_out

    # train on frame pairs of KITTI-profile synthetic worlds (kitti_preset:
    # 64x720 beams, moving traffic; sequence ids are world seeds, 100 + s for
    # training, 1100 + s for eval), then test on held-out worlds (2100 + s)
    python train_net_torch.py --do_train --dataset synthetic_world \
        --train_sequences 0,1,2,3 --eval_sequences 0 --synthetic_frames 240 \
        --log_dir ./train_out
    python train_net_torch.py --do_test --dataset synthetic_world \
        --test_sequences 9 --fused_eval --log_dir ./train_out

    # train on KITTI-360 drives (data_3d_raw, data_poses, calibration under
    # root_dir), then test on one with the fused eval kernels
    python train_net_torch.py --do_train --dataset kitti360 --root_dir /data/kitti360 \
        --train_sequences 0,2,3,4,5,6,7 --eval_sequences 9 --log_dir ./train_out
    python train_net_torch.py --do_test --dataset kitti360 --root_dir /data/kitti360 \
        --test_sequences 10 --fused_eval --log_dir ./train_out

    # test: odometry over sequences with the latest checkpoint of log_dir
    python train_net_torch.py --do_test --dataset kitti --root_dir /data/kitti \
        --test_sequences 9,10 --log_dir ./train_out

    # PoseResNet on 64x720 vertex-map pairs (config/train_posenet.yaml)
    python train_net_torch.py config=train_posenet do_train=true root_dir=/data/kitti \
        log_dir=./posenet_out

    # PointNet++ SSG classifier on ModelNet40 (1024 points, batch 32), or on
    # procedural shapes with --dataset synthetic; writes cls_seg_state.pkl
    python train_net_torch.py --do_train --model cls --dataset modelnet40 \
        --root_dir /data/modelnet40_normal_resampled --num_points 1024 --batch_size 32

    # PointNet++ SSG segmenter on the Indoor3D blocks (4096 points x 9), or
    # on procedural rooms with --dataset synthetic
    python train_net_torch.py --do_train --model semseg --dataset indoor3d \
        --root_dir /data/indoor3d_sem_seg_hdf5_data --num_points 4096 --batch_size 32

Options are ``--key value`` (a bare ``--flag`` means true) or the
``key=value`` / ``config=<yaml>`` form of ``train_net.py``. Everything runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from typing import List, Optional

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.data import shapes
from pwclonet_pylidarslam_torch.data.kitti import KittiPairDataset, KittiSequence
from pwclonet_pylidarslam_torch.data.other_datasets import Kitti360PairDataset, Kitti360Sequence
from pwclonet_pylidarslam_torch.data.synthetic import (
    SyntheticPairDataset,
    SyntheticSequenceConfig,
    generate_sequence,
    kitti_preset,
)
from pwclonet_pylidarslam_torch.data.vm_pairs import (
    MultiSequenceWindowDataset,
    VertexMapPairDataset,
    VertexMapWindowDataset,
    concat_pair_datasets,
)
from pwclonet_pylidarslam_torch.evaluation.results import OdometryResults, write_devkit_report
from pwclonet_pylidarslam_torch.models import (
    PointNet2Classification,
    PointNet2Segmentation,
    scaled_model_config,
)
from pwclonet_pylidarslam_torch.models.convert import flax_variables
from pwclonet_pylidarslam_torch.models.posenet import PoseResNetConfig
from pwclonet_pylidarslam_torch.slam.deep_odometry import (
    DeepOdometryConfig,
    PoseNetOdometry,
    PoseNetOdometryConfig,
    PWCLONetOdometry,
)
from pwclonet_pylidarslam_torch.train.cls_seg import (
    ClsSegTrainConfig,
    cls_seg_eval_step,
    cls_seg_train_step,
    create_cls_seg_state,
)
from pwclonet_pylidarslam_torch.train.posenet_state import PoseNetTrainConfig
from pwclonet_pylidarslam_torch.train.posenet_trainer import PoseNetTrainer, PoseNetTrainerConfig
from pwclonet_pylidarslam_torch.train.state import TrainConfig
from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig
from pwclonet_pylidarslam_torch.utils.config import dump_config, parse_cli

MODELS = ("pwclonet", "posenet", "cls", "semseg")
DATASETS = ("synthetic", "synthetic_world", "kitti", "kitti360", "modelnet40", "indoor3d")


@dataclasses.dataclass
class Config:
    do_train: bool = False
    do_test: bool = False
    model: str = "pwclonet"  # pwclonet | posenet | cls | semseg
    # synthetic | synthetic_world | kitti | kitti360 | modelnet40 (cls) | indoor3d (semseg)
    dataset: str = "synthetic"
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
    # dataset=synthetic_world: frames per generated world sequence (sequence
    # ids act as world seeds; train/eval/test use disjoint seed ranges)
    synthetic_frames: int = 240
    profile_dir: str = ""  # a torch.profiler trace of the training (utils/timer.py)
    fused_eval: bool = False  # test mode: the fused eval kernels
    posenet_loss: str = "supervised"  # model=posenet: supervised | unsupervised
    # model=posenet: frames a window (2: pairs; more: one pose per pair)
    sequence_len: int = 2
    vm_height: int = 64
    vm_width: int = 720
    device: str = "cuda"


def _seqs(s) -> List[int]:
    return [int(x) for x in str(s).strip("[]").split(",") if x != ""]


def _check_config(config: Config) -> None:
    if config.model not in MODELS or config.dataset not in DATASETS:
        raise ValueError(f"unknown model/dataset {config.model!r}/{config.dataset!r}")
    if config.model in ("cls", "semseg") and config.do_test and not config.do_train:
        raise ValueError(f"model={config.model} has a train mode only (do_train)")


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

    if config.dataset == "synthetic_world":
        # frame pairs of KITTI-profile worlds: sequence ids are world seeds;
        # eval worlds use seed + 1000
        def make_ds(seed_ids, offset, augment, seed):
            seqs = [
                generate_sequence(kitti_preset(n_frames=config.synthetic_frames, seed=offset + s),
                                  device=config.device)
                for s in seed_ids
            ]
            return SyntheticPairDataset(seqs, num_points=config.num_points, augment=augment,
                                        seed=seed)

        train_ds = make_ds(_seqs(config.train_sequences), 100, config.augment, config.seed)
        eval_ds = make_ds(_seqs(config.eval_sequences), 1100, False, config.seed + 1)
        epoch = [0]

        def train_fn():
            epoch[0] += 1
            return train_ds.batches(config.batch_size, shuffle=True, seed=epoch[0])

        return train_fn, (lambda: eval_ds.batches(config.batch_size, shuffle=False))

    # dataset=kitti360 (ref train.py:337-345): the KITTI pair dataset's contract
    pairs = Kitti360PairDataset if config.dataset == "kitti360" else KittiPairDataset
    train_ds = pairs(
        config.root_dir, tuple(_seqs(config.train_sequences)),
        num_points=config.num_points, augment=config.augment, seed=config.seed,
    )
    eval_ds = pairs(
        config.root_dir, tuple(_seqs(config.eval_sequences)),
        num_points=config.num_points, augment=False, seed=config.seed + 1,
    )
    return (
        lambda: train_ds.batches(config.batch_size, shuffle=True),
        lambda: eval_ds.batches(config.batch_size, shuffle=False),
    )


class _SyntheticTestSequence:
    """A sequence from the port's generator: ``dataset=synthetic``, a
    16-frame corridor; ``synthetic_world``, a held-out KITTI-profile world
    (seed 2100 + the sequence id)."""

    def __init__(self, config: Config, s: int):
        if config.dataset == "synthetic_world":
            cfg = kitti_preset(n_frames=config.synthetic_frames, seed=2100 + s)
        else:
            cfg = SyntheticSequenceConfig(n_frames=16, seed=s, num_points=config.num_points)
        self.scans, self.poses = generate_sequence(cfg, device=config.device)

    def __len__(self):
        return len(self.scans)

    def scan(self, i):
        return self.scans[i]

    def ground_truth(self):
        return self.poses


def make_test_sequence(config: Config, s: int):
    """The test-mode sequence of both test CLIs (pwclonet and posenet share
    the dataset selection)."""
    if config.dataset in ("synthetic", "synthetic_world"):
        return _SyntheticTestSequence(config, s)
    if config.dataset == "kitti360":
        return Kitti360Sequence(config.root_dir, s)
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
                SyntheticSequenceConfig(n_frames=16 + 2 * config.synthetic_batches, seed=seed),
                device=config.device)
            datasets.append(make_ds(scans, gt, num_points=scans.shape[1]))
        else:
            # dataset=synthetic_world trains on KITTI under root_dir here, as
            # train_net.py's posenet branch does (its test mode takes the worlds)
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


def _cls_seg_setup(config: Config, train: bool):
    """``(classes, dataset)`` of ``model=cls|semseg``, as ``train_net.py``
    pairs them: ModelNet40 or procedural shapes for cls, the Indoor3D blocks
    or procedural rooms for semseg; the class count follows the dataset."""
    synthetic = dict(num_items=config.synthetic_batches * config.batch_size,
                     num_points=config.num_points, seed=config.seed if train else config.seed + 1)
    if config.model == "cls":
        if config.dataset == "modelnet40":
            ds = shapes.ModelNet40Dataset(config.root_dir, num_points=config.num_points,
                                          train=train)
            return len(ds.classes), ds
        return len(shapes.SHAPE_CLASSES), shapes.SyntheticShapes(**synthetic)
    if config.dataset == "indoor3d":
        ds = shapes.Indoor3DSemSegDataset(config.root_dir, num_points=config.num_points,
                                          train=train)
        return ds.NUM_CLASSES, ds
    ds = shapes.SyntheticRooms(**synthetic)
    return ds.num_classes, ds


def run_train_cls_seg(config: Config) -> int:
    """``model=cls|semseg``: train for ``num_epochs``, printing the train and
    eval loss and accuracy of each epoch, then write the parameters and
    running statistics to ``<log_dir>/cls_seg_state.pkl`` in the layout of
    ``train_net.py`` (nested numpy trees under Flax's names, which
    ``models/convert.py::load_flax_variables`` reads)."""
    n_classes, train_ds = _cls_seg_setup(config, train=True)
    _, eval_ds = _cls_seg_setup(config, train=False)
    cls = config.model == "cls"
    cfg = ClsSegTrainConfig(learning_rate=config.learning_rate, batch_size=config.batch_size,
                            lr_decay=0.7 if cls else 0.5, decay_step=2e4 if cls else 3e5)
    dump_config(config, f"{config.log_dir}/config.yaml")
    # the input width from a first batch, drawn as train_net.py draws it
    example = next(shapes.batches(train_ds, config.batch_size, np.random.default_rng(0)))
    width = example["points"].shape[-1]
    net = PointNet2Classification if cls else PointNet2Segmentation
    model = net(n_classes, in_channels=width - 3 if width > 3 else None, seed=config.seed,
                device=config.device)
    state = create_cls_seg_state(model, cfg, seed=config.seed)
    for epoch in range(config.num_epochs):
        rng = np.random.default_rng((config.seed, epoch))
        logs = [cls_seg_train_step(cfg, state, batch) for batch in shapes.batches(
            train_ds, config.batch_size, rng, augment=config.augment and cls)]
        evals = [cls_seg_eval_step(state, batch)
                 for batch in shapes.batches(eval_ds, config.batch_size, shuffle=False)]

        def mean(rows, key):  # one read of the device a column
            return float(torch.stack([r[key] for r in rows]).mean()) if rows else float("nan")

        print(f"epoch {epoch}: loss={mean(logs, 'loss'):.4f} acc={mean(logs, 'accuracy'):.3f} "
              f"eval_loss={mean(evals, 'loss'):.4f} eval_acc={mean(evals, 'accuracy'):.3f}")
    with open(f"{config.log_dir}/cls_seg_state.pkl", "wb") as f:
        pickle.dump(flax_variables(state.model), f)
    return 0


def run_train(config: Config) -> int:
    if config.model == "posenet":
        return run_train_posenet(config)
    if config.model in ("cls", "semseg"):
        return run_train_cls_seg(config)
    trainer = _trainer(config, num_epochs=config.num_epochs)
    dump_config(config, f"{config.log_dir}/config.yaml")
    train_fn, eval_fn = make_batch_fns(config)
    if config.profile_dir:
        from pwclonet_pylidarslam_torch.utils.timer import profiler_trace

        with profiler_trace(config.profile_dir, device=config.device):
            history = trainer.fit(train_fn, eval_fn)
    else:
        history = trainer.fit(train_fn, eval_fn)
    _print_done(history)
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
    _check_config(config)
    os.makedirs(config.log_dir, exist_ok=True)
    if config.do_train:
        return run_train(config)
    if config.do_test:
        return run_test(config)
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
