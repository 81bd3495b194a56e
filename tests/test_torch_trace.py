"""The program's spans and counters (``utils/timer.py``): off, nesting,
threads, counters, and the spans a small odometry call and a small training
block record at the layer boundaries, on the CPU."""

import threading

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.utils import timer

SMALL = dict(num_points=128, sa_npoints=(32, 16, 8, 4), sa_nsamples=(8, 8, 4, 4))


def _tree(record):
    """``{span index: (name, parent name)}`` of a record."""
    names = [s[0] for s in record.spans]
    return [(s[0], None if s[1] is None else names[s[1]]) for s in record.spans]


def _parents(record, name):
    return {p for n, p in _tree(record) if n == name}


def test_off_records_nothing_and_returns_the_shared_noop():
    assert timer.span("a.b") is timer.span("a.b")

    @timer.span("a.f")
    def f(x):
        timer.count("a.c", 3)
        return x + 1

    with timer.span("a.b"):
        assert f(1) == 2
    with timer.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert timer.span("a.b") is timer.span("a.b")  # off again once it ended


def test_nesting_and_parents():
    @timer.span("t.inner")
    def inner():
        with timer.span("t.leaf"):
            pass

    with timer.recording() as rec:
        with timer.span("t.outer"):
            inner()
            inner()
        with timer.span("t.second"):
            pass
    assert [s[0] for s in rec.spans] == ["t.outer", "t.inner", "t.leaf", "t.inner", "t.leaf",
                                         "t.second"]
    assert [s[1] for s in rec.spans] == [None, 0, 1, 0, 3, None]
    for name, parent, thread, start, end in rec.spans:
        assert thread == rec.thread and start <= end
        if parent is not None:
            p = rec.spans[parent]
            assert p[3] <= start and end <= p[4]
    with timer.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with timer.recording():
                pass


def test_per_thread_stacks():
    """A span opened on another thread while the main thread's is open has
    no parent there; its own children have it as theirs."""
    opened, release = threading.Event(), threading.Event()

    def worker():
        with timer.span("w.outer"):
            opened.set()
            release.wait(10)
            with timer.span("w.inner"):
                pass

    with timer.recording() as rec:
        with timer.span("m.outer"):
            t = threading.Thread(target=worker)
            t.start()
            assert opened.wait(10)
            with timer.span("m.inner"):
                release.set()
                t.join(10)
        assert not t.is_alive()
    by_name = {s[0]: s for s in rec.spans}
    assert by_name["w.outer"][1] is None
    assert rec.spans[by_name["w.inner"][1]][0] == "w.outer"
    assert rec.spans[by_name["m.inner"][1]][0] == "m.outer"
    assert by_name["w.outer"][2] != by_name["m.outer"][2] == rec.thread


def test_counters():
    with timer.recording() as rec:
        timer.count("c.rows", 5)
        timer.count("c.rows", 7)
        timer.count("c.calls")
    timer.count("c.rows", 100)  # off: nothing
    assert rec.counters == {"c.rows": 12, "c.calls": 1}


def test_odometry_call_records_the_layer_spans():
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.slam.deep_odometry import (
        DeepOdometryConfig,
        PWCLONetOdometry,
    )

    cfg = PWCLONetConfig(fused_eval=True, **SMALL)
    odo = PWCLONetOdometry(config=DeepOdometryConfig(model=cfg, num_points=128), device="cpu")
    odo.init()
    scans = np.random.default_rng(0).normal(size=(3, 300, 3)).astype(np.float32) * 10
    with timer.recording() as rec:
        odo.process_sequence(scans)
    tree = _tree(rec)
    assert tree[0] == ("odometry.call", None)
    assert [n for n, p in tree if p == "odometry.call"] == [
        "odometry.prepare", "odometry.forward", "odometry.readback", "odometry.chain"]
    assert [n for n, p in tree if p == "odometry.prepare"] == [
        "odometry.h2d", "op.prepare_keep", "odometry.draw", "odometry.h2d", "op.prepare_take"]
    assert [n for n, p in tree if p == "odometry.forward"] == [
        "model.pyramid", "model.coarse", "model.refine"]
    for op in ("op.fps", "op.knn", "op.gather", "op.mlp_maxpool", "op.attentive_aggregate"):
        assert _parents(rec, op) - {"op.knn"} <= {"model.pyramid", "model.coarse",
                                                 "model.refine"}, op
    assert not _parents(rec, "op.scatter_sum")  # no backward in eval
    # the raw rows and their offsets, then the drawn indices
    assert rec.counters == {"odometry.points_in": 3 * 300,
                            "h2d.bytes": 3 * 300 * 3 * 4 + 4 * 8 + 3 * 128 * 4,
                            "odometry.scans_padded": 0}


def test_train_block_records_the_layer_spans():
    from pwclonet_pylidarslam_torch.data.synthetic import SyntheticPairDataset
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.train.state import TrainConfig
    from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig

    rng = np.random.default_rng(1)
    scans = rng.normal(size=(4, 400, 3)).astype(np.float32) * 8
    poses = np.tile(np.eye(4), (4, 1, 1))
    data = SyntheticPairDataset([(scans, poses)], num_points=128, seed=0)
    trainer = PWCLONetTrainer(
        TrainerConfig(train=TrainConfig(model=PWCLONetConfig(**SMALL), total_steps=10),
                      steps_per_dispatch=2, checkpoint_every_epochs=0), device="cpu")
    with timer.recording() as rec:
        trainer.train_epoch(data.batches(1, shuffle=False))
    tree = _tree(rec)
    # three pairs: a block of two steps, then one of one
    children = [n for n, p in tree if p == "train.block"]
    assert children == ["train.stack", "train.step", "train.step", "train.readback",
                        "train.stack", "train.step", "train.readback"]
    assert [n for n, p in tree if p == "train.step"] == [
        "train.h2d", "train.forward", "train.backward", "train.optimizer"] * 3
    assert _parents(rec, "model.pyramid") == {"train.forward"}
    # the scatter-add is the gather's backward (on the CPU, the caller's thread)
    assert _parents(rec, "op.scatter_plan") == _parents(rec, "op.scatter_sum") == {
        "train.backward"}
    assert _parents(rec, "data.filter") == {"data.pair"}
    assert _parents(rec, "data.augment") == {"data.pair"}
    assert _parents(rec, "data.pair") == _parents(rec, "data.collate") == {None}
    assert sum(n == "data.pair" for n, _ in tree) == 3
    pair_bytes = (2 * 128 * 3 + 7) * 4  # xyz1, xyz2, gt_params, float32
    assert rec.counters == {"data.points_in": 3 * 2 * 400, "train.steps": 3,
                            "h2d.bytes": 3 * pair_bytes}


def test_segmenter_step_records_the_layer_spans():
    from pwclonet_pylidarslam_torch.data.shapes import batches
    from pwclonet_pylidarslam_torch.models.cls_seg import PointNet2Segmentation, SAStage
    from pwclonet_pylidarslam_torch.train.cls_seg import (
        ClsSegTrainConfig,
        cls_seg_train_step,
        create_cls_seg_state,
    )

    stages = (SAStage(16, (0.4,), (8,), ((8, 8),)), SAStage(4, (0.8,), (4,), ((8, 16),)))
    model = PointNet2Segmentation(3, stages=stages, fp_width=8, head_width=8, in_channels=3,
                                  device="cpu")
    state = create_cls_seg_state(model, ClsSegTrainConfig(batch_size=2))
    rng = np.random.default_rng(2)
    items = [(rng.normal(size=(64, 6)).astype(np.float32), rng.integers(0, 3, 64))
             for _ in range(4)]
    with timer.recording() as rec:
        for batch in batches(items, 2, rng=rng):
            cls_seg_train_step(ClsSegTrainConfig(batch_size=2), state, batch)
    tree = _tree(rec)
    assert [n for n, p in tree if p is None] == ["data.collate", "train.step"] * 2
    assert [n for n, p in tree if p == "train.forward"] == [
        "model.encoder", "model.decoder", "model.head"] * 2
    assert {"op.ball_query", "op.fps", "op.gather"} <= {n for n, p in tree
                                                        if p == "model.encoder"}
    assert _parents(rec, "op.three_nn") == _parents(rec, "op.three_interpolate") == {
        "model.decoder"}
    assert _parents(rec, "op.scatter_sum") == {"train.backward"}
    assert rec.counters["train.steps"] == 2


def test_spans_cost_nothing_to_the_results():
    """The same call with the recording on and off gives the same poses."""
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.slam.deep_odometry import (
        DeepOdometryConfig,
        PWCLONetOdometry,
    )

    scans = np.random.default_rng(3).normal(size=(2, 200, 3)).astype(np.float32) * 10
    out = []
    for on in (False, True):
        odo = PWCLONetOdometry(config=DeepOdometryConfig(model=PWCLONetConfig(**SMALL),
                                                         num_points=128), device="cpu")
        odo.init()
        if on:
            with timer.recording():
                out.append(odo.process_sequence(scans))
        else:
            out.append(odo.process_sequence(scans))
    assert np.array_equal(out[0], out[1])
    assert torch.equal(torch.from_numpy(out[0]), torch.from_numpy(out[1]))
