"""PWCLO-Net training: ``PWCLONetTrainer.train_epoch`` over
``SyntheticPairDataset.batches``, a block of ``steps_per_dispatch`` steps a
call, closed loop.

Set-up casts the drives, builds the trainer with the benchmark's weights
and dropout generator, and drives it through its first three steps by the
window's own call (one step, then two), keeping the first gradient as Adam
holds it and the parameters after the third; then one block to warm up.
The check builds the three batches again from the drives and the feed's
seed (``benchmark/reference/pairs.py``), runs the reference over them from
the same weights and compares the losses, the first gradient and the change:
a fault in the program's feed (its filter, augmentation or ground truth)
shows there as one in its step does.
"""

from __future__ import annotations

import itertools
import tempfile
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.driver import Base, Done, Feed, Phases, on_device
from benchmark.reference import adam, pairs, params, pwclonet as ref_net, world


def _trainables(spec) -> list:
    return [name for name, _, kind in spec if kind not in ("mean", "var")]


class Driver(Base):
    train = True

    def __init__(self, config: Dict, workload: Dict, seed: int, device: torch.device):
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.batch = workload["batch"]
        self.block = workload["steps_per_dispatch"]
        self.phases = Phases()

    # ------------------------------------------------------------ set-up

    def _drives(self):
        inp = self.config["input"]
        sensor = world.Sensor(inp["num_beams"], inp["num_cols"], inp["fov_up_deg"],
                              inp["fov_down_deg"], inp["noise_std"], inp["dropout"])
        return [world.make_drive(sensor, self.workload["frames_per_drive"], (self.seed, i),
                                 self.device, start=self.workload["drive_starts"][i])
                for i in range(self.workload["drives"])]

    def setup(self) -> None:
        from pwclonet_pylidarslam_torch.data.synthetic import SyntheticPairDataset
        from pwclonet_pylidarslam_torch.models import PWCLONetConfig
        from pwclonet_pylidarslam_torch.train.state import TrainConfig
        from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig

        c, tc = self.config, self.config["train"]
        with self.phases("drives"):
            self.drives = self._drives()
        dataset = SyntheticPairDataset(self.drives, num_points=c["num_points"],
                                       max_frame_gap=self.workload["max_frame_gap"],
                                       augment=self.workload["augment"], seed=self.seed)
        self.feed = Feed(dataset.batches(self.batch) for _ in itertools.count())
        model = PWCLONetConfig(num_points=c["num_points"], sa_npoints=tuple(c["sa_npoints"]),
                               sa_nsamples=tuple(c["sa_nsamples"]),
                               sa_mlps=tuple(tuple(m) for m in c["sa_mlps"]))
        train = TrainConfig(model=model, learning_rate=tc["learning_rate"], lr_min=tc["lr_min"],
                            total_steps=tc["total_steps"], bn_momentum_init=tc["bn_momentum_init"])
        self._logdir = tempfile.TemporaryDirectory(prefix="bench_pwclo_")
        with self.phases("model"):
            self.trainer = PWCLONetTrainer(
                TrainerConfig(train=train, steps_per_dispatch=self.block,
                              log_dir=self._logdir.name, checkpoint_every_epochs=0,
                              seed=self.seed % (2 ** 31)),
                device=self.device)
            state = self.trainer.state
            self.spec = params.spec_of(c)
            self.weights = params.make_weights(c, self.seed, self.device)
            state.model.load_state_dict(self.weights)
        with torch.no_grad():
            state.loss_params["s_param"].copy_(torch.tensor(tc["loss_init_weights"]))
        state.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        names = ["net." + n for n in _trainables(self.spec)] + ["loss.s_param"]
        named = state.trainable()
        p0 = {n: named[n].detach().clone() for n in names}
        # the first three steps, by the window's own call
        with self.phases("first_steps"):
            self.trainer.train_epoch(itertools.islice(self.feed, 1))
            losses = list(self.trainer.last_epoch_logs["loss"])
            opt = state.optimizer
            views = dict(zip(opt.names, opt._views(opt.exp_avg)))
            self.grad1 = {n: (views[n] / (1.0 - opt.b1)).clone() for n in names}
            self.trainer.train_epoch(itertools.islice(self.feed, 2))
            losses += list(self.trainer.last_epoch_logs["loss"])
            named = state.trainable()
            self.change = {n: named[n].detach() - p0[n] for n in names}
            self.losses = [float(x) for x in losses]
            self.first_batches = self.feed.kept[:3]
        with self.phases("warm_up"):
            self.trainer.train_epoch(itertools.islice(self.feed, self.block))

    # ------------------------------------------------------------ timed path

    def reset_counters(self) -> None:
        self.feed.seconds, self.feed.count = 0.0, 0

    @property
    def counters(self):
        return {"input_s": self.feed.seconds, "input_steps": self.feed.count}

    def call(self) -> Done:
        self.trainer.train_epoch(itertools.islice(self.feed, self.block))
        losses = self.trainer.last_epoch_logs["loss"]
        n = len(losses) * self.batch
        return Done(n, n, bool(np.all(np.isfinite(losses))))

    def stretch(self, spans):
        self.feed.spans = spans
        with spans.span("bench.call"):
            done = self.call()
        self.feed.spans = None
        return 1, done.work_units

    def free(self) -> None:
        del self.trainer
        self._logdir.cleanup()

    # ------------------------------------------------------------ check

    def reference_batches(self) -> list:
        """The first three batches as the reference builds them."""
        w = self.workload
        feed = pairs.Pairs(self.drives, self.config["num_points"], w["max_frame_gap"],
                           w["augment"], self.seed).batches(self.batch)
        return list(itertools.islice(feed, 3))

    def reference(self, precision: str = "float32", half_batch: bool = False) -> Dict:
        """The reference's three steps on its own batches: losses, first
        gradient, change."""
        c, tc = self.config, self.config["train"]
        names = _trainables(self.spec)
        p = {n: self.weights[n].detach().clone().requires_grad_(True) for n in names}
        p["s_param"] = torch.tensor(tc["loss_init_weights"], device=self.device,
                                    requires_grad=True)
        buffers = {n: self.weights[n] for n, _, kind in self.spec if kind in ("mean", "var")}
        p0 = {k: v.detach().clone() for k, v in p.items()}
        opt = adam.Adam(p)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        losses, grad1 = [], None
        for step, batch in enumerate(self.reference_batches()):
            b = on_device(batch, self.device)
            if half_batch:  # a fault: half of each batch left out
                b = {k: v[: len(v) // 2] for k, v in b.items()}
            net = ref_net.Net(c, {**buffers, **p}, precision, train=True, generator=gen)
            pred = net(b["xyz1"], b["xyz2"])
            loss = ref_net.loss(p["s_param"], pred, b["gt_params"], tc["loss_level_weights"])
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: v.detach().clone() for k, v in grads.items()}
            opt.update(p, grads, ref_net.cosine_lr(step, tc["learning_rate"], tc["lr_min"],
                                                   tc["total_steps"]))
            del net, pred, loss, grads
        return {"losses": losses, "grad": grad1,
                "change": {k: p[k].detach() - p0[k] for k in p}}

    def program(self) -> Dict:
        rename = {("net." + n): n for n in _trainables(self.spec)}
        rename["loss.s_param"] = "s_param"
        return {"losses": self.losses,
                "grad": {rename[k]: v for k, v in self.grad1.items()},
                "change": {rename[k]: v for k, v in self.change.items()}}

    def readings(self) -> Dict[str, float]:
        return compare.train_readings(self.program(), self.reference())

    def fault_readings(self) -> Dict[str, float]:
        """Half of each batch left out, the mean taken over the rest, in the
        reference put in the program's place."""
        return compare.train_readings(self.reference(half_batch=True), self.reference())

    def control_readings(self, precision: str) -> Dict[str, float]:
        """The reference in ``precision`` put in the program's place."""
        return compare.train_readings(self.reference(precision), self.reference())
