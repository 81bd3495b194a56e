"""PointNet++ segmentation training: ``cls_seg_train_step`` over batches
from ``data/shapes.py::batches``, closed loop, the losses of a block of
steps read back once at its end.

Set-up makes the blocks, builds the network and its train state with the
benchmark's weights and dropout generator, and drives the state through its
first three steps by the window's own step and feed, keeping the first
gradient as Adam holds it and the parameters after the third; then one block
to warm up. The check draws the first three batches again from the blocks
and the feed's seed (a permutation of the blocks, batches in its order) and
runs the reference over them.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.driver import Base, Done, Feed, Phases, on_device
from benchmark.reference import adam, params, pointnet2 as ref_net, rooms


class Blocks:
    """The dataset the feed reads: ``(points (N, 9), labels (N,))`` items."""

    def __init__(self, points: np.ndarray, labels: np.ndarray):
        self.points, self.labels = points, labels

    def __len__(self) -> int:
        return len(self.points)

    def __getitem__(self, i: int):
        return self.points[i], self.labels[i]


class Driver(Base):
    train = True

    def __init__(self, config: Dict, workload: Dict, seed: int, device: torch.device):
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.batch = workload["batch"]
        self.block = workload["steps_per_dispatch"]
        self.phases = Phases()

    def setup(self) -> None:
        from pwclonet_pylidarslam_torch.data.shapes import batches
        from pwclonet_pylidarslam_torch.models.cls_seg import PointNet2Segmentation, SAStage
        from pwclonet_pylidarslam_torch.train.cls_seg import (
            ClsSegTrainConfig,
            cls_seg_train_step,
            create_cls_seg_state,
        )

        c, tc = self.config, self.config["train"]
        with self.phases("blocks"):
            pts, labels = rooms.room_blocks(self.seed, self.workload["blocks"], c["num_points"])
        data = self.data = Blocks(pts, labels)
        rng = np.random.default_rng(self.feed_seed)
        self.feed = Feed(batches(data, self.batch, rng=rng) for _ in itertools.count())
        stages = tuple(SAStage(s["npoint"], (s["radius"],), (s["nsample"],), (tuple(s["mlp"]),))
                       for s in c["stages"])
        with self.phases("model"):
            model = PointNet2Segmentation(c["num_classes"], stages, fp_width=c["fp_width"],
                                          head_width=c["head_width"], dropout=c["dropout"],
                                          in_channels=c["in_channels"] - 3, device=self.device)
            self.spec = params.spec_of(c)
            self.weights = params.make_weights(c, self.seed, self.device)
            model.load_state_dict(self.weights)
            self.train_config = ClsSegTrainConfig(
                learning_rate=tc["learning_rate"], lr_decay=tc["lr_decay"],
                decay_step=tc["decay_step"], bn_momentum=tc["bn_momentum"],
                bnm_decay=tc["bnm_decay"], batch_size=self.batch)
            self.state = create_cls_seg_state(model, self.train_config)
        self.state.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self._step = cls_seg_train_step
        named = dict(model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named.items()}
        with self.phases("first_steps"):
            self.losses = [float(self._steps(1)[0])]
            b1 = self.state.optimizer.defaults["betas"][0]
            held = {n: self.state.optimizer.state.get(p, {}).get("exp_avg")
                    for n, p in named.items()}
            # the first gradient as Adam holds it; none where it took no step
            self.grad1 = {n: torch.zeros_like(named[n]) if m is None else (m / (1.0 - b1)).clone()
                          for n, m in held.items()}
            self.losses += [float(x) for x in self._steps(2)]
            self.change = {n: p.detach() - p0[n] for n, p in named.items()}
            self.first_batches = self.feed.kept[:3]
        with self.phases("warm_up"):
            self._steps(self.block)

    def _steps(self, k: int) -> np.ndarray:
        """``k`` steps, then their losses read back."""
        logs = [self._step(self.train_config, self.state, batch)["loss"]
                for batch in itertools.islice(self.feed, k)]
        return torch.stack(logs).cpu().numpy()

    def reset_counters(self) -> None:
        self.feed.seconds, self.feed.count = 0.0, 0

    @property
    def counters(self):
        return {"input_s": self.feed.seconds, "input_steps": self.feed.count}

    def call(self) -> Done:
        losses = self._steps(self.block)
        n = len(losses) * self.batch
        return Done(n, n, bool(np.all(np.isfinite(losses))))

    def stretch(self, spans):
        self.feed.spans = spans
        with spans.span("bench.call"):
            done = self.call()
        self.feed.spans = None
        return 1, done.work_units

    def free(self) -> None:
        del self.state

    # ------------------------------------------------------------ check

    @property
    def feed_seed(self):
        return (self.seed, 3)

    def reference_batches(self) -> list:
        """The first three batches as the reference draws them: the blocks in
        the order of one permutation drawn from the feed's seed."""
        order = np.random.default_rng(self.feed_seed).permutation(len(self.data))
        return [{"points": self.data.points[order[k * self.batch:(k + 1) * self.batch]],
                 "labels": self.data.labels[order[k * self.batch:(k + 1) * self.batch]]}
                for k in range(3)]

    def reference(self, precision: str = "float32", half_batch: bool = False) -> Dict:
        c, tc = self.config, self.config["train"]
        trainable = [n for n, _, kind in self.spec if kind not in ("mean", "var")]
        p = {n: self.weights[n].detach().clone().requires_grad_(True) for n in trainable}
        buffers = {n: self.weights[n] for n, _, kind in self.spec if kind in ("mean", "var")}
        p0 = {k: v.detach().clone() for k, v in p.items()}
        opt = adam.Adam(p)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        losses, grad1 = [], None
        for step, batch in enumerate(self.reference_batches()):
            b = on_device(batch, self.device)
            if half_batch:  # a fault: half of each batch left out
                b = {k: v[: len(v) // 2] for k, v in b.items()}
            pts = b["points"]
            logits = ref_net.forward(c, {**buffers, **p}, pts[..., :3], pts[..., 3:], True,
                                     precision, gen)
            loss = ref_net.loss(logits, b["labels"])
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: v.detach().clone() for k, v in grads.items()}
            opt.update(p, grads, ref_net.staircase_lr(step * self.batch, tc))
            del logits, loss, grads
        return {"losses": losses, "grad": grad1,
                "change": {k: p[k].detach() - p0[k] for k in p}}

    def program(self) -> Dict:
        return {"losses": self.losses, "grad": self.grad1, "change": self.change}

    def readings(self) -> Dict[str, float]:
        return compare.train_readings(self.program(), self.reference())

    def fault_readings(self) -> Dict[str, float]:
        """Half of each batch left out, the mean taken over the rest, in the
        reference put in the program's place."""
        return compare.train_readings(self.reference(half_batch=True), self.reference())

    def control_readings(self, precision: str) -> Dict[str, float]:
        return compare.train_readings(self.reference(precision), self.reference())
