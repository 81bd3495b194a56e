"""The check that decides ``correct``: a sound run passes it, and each fault
a cell can have, planted under the timed path, fails it; so does the
control, the reference in the next lower precision put in the program's
place. Runs on the CPU at a size a test run can hold; the harness's look for
a card is skipped, the rest of a run is driven as on the card."""

import numpy as np
import pytest
import torch

from tiny import SEED, tiny_cell

from benchmark.harness import compare, runner

CPU = torch.device("cpu")
# every configuration states float32 with TF32 off: the control is TF32
CONTROL = {"pwclonet-train-b8": "tf32", "pwclonet-odometry-seq32": "tf32",
           "pointnet2-semseg-train-b32": "tf32"}


def _run(name):
    return runner.run_cell(tiny_cell(name), SEED, 0.3, False, CPU, 0.0)


@pytest.mark.parametrize("name", list(CONTROL))
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]


# ---------------------------------------------------------------- faults


def _state_unchanged_pwclo(monkeypatch):
    from pwclonet_pylidarslam_torch.models.layers import discard_batch_stats
    from pwclonet_pylidarslam_torch.train import state as st, trainer

    def steps(config, state, block):
        logs = []
        for batch in st._unstack(block):
            loss, log, _ = st.loss_and_grads(config, state, batch)
            discard_batch_stats(state.model)
            state.step += 1
            logs.append(log)
        return {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}

    monkeypatch.setattr(trainer, "train_steps", steps)


def _half_batch_pwclo(monkeypatch):
    from pwclonet_pylidarslam_torch.train import trainer

    real = trainer.train_steps

    def steps(config, state, block):
        half = {k: v[:, : max(1, v.shape[1] // 2)] for k, v in block.items()}
        return real(config, state, half)

    monkeypatch.setattr(trainer, "train_steps", steps)


def _ground_truth_altered_pwclo(monkeypatch):
    from pwclonet_pylidarslam_torch.data import synthetic

    real = synthetic.SyntheticPairDataset.__getitem__

    def item(self, index):
        out = real(self, index)
        out["gt_params"] = out["gt_params"].copy()
        out["gt_params"][2] += 0.5  # the ground truth 0.5 m off where the feed makes it
        return out

    monkeypatch.setattr(synthetic.SyntheticPairDataset, "__getitem__", item)


def _state_unchanged_semseg(monkeypatch):
    from pwclonet_pylidarslam_torch.models.layers import discard_batch_stats
    from pwclonet_pylidarslam_torch.train import cls_seg

    def step(config, state, batch):
        loss, acc, _ = cls_seg.cls_seg_loss_and_grads(config, state, batch)
        discard_batch_stats(state.model)
        state.step += 1
        return {"loss": loss, "accuracy": acc}

    monkeypatch.setattr(cls_seg, "cls_seg_train_step", step)


def _half_batch_semseg(monkeypatch):
    from pwclonet_pylidarslam_torch.train import cls_seg

    real = cls_seg.cls_seg_train_step

    def step(config, state, batch):
        half = {k: np.asarray(v)[: max(1, len(v) // 2)] for k, v in batch.items()}
        return real(config, state, half)

    monkeypatch.setattr(cls_seg, "cls_seg_train_step", step)


def _answer_altered(monkeypatch):
    from pwclonet_pylidarslam_torch.slam import deep_odometry

    real = deep_odometry.PWCLONetOdometry._relative_poses

    def rel(self, cur, prev):
        out = real(self, cur, prev).copy()
        out[len(out) // 2, 0, 3] += 1.0  # one pose of each call, 1 m off
        return out

    monkeypatch.setattr(deep_odometry.PWCLONetOdometry, "_relative_poses", rel)


FAULTS = [
    ("pwclonet-train-b8", "state unchanged", _state_unchanged_pwclo),
    ("pwclonet-train-b8", "half of the batch", _half_batch_pwclo),
    ("pwclonet-train-b8", "an answer altered", _ground_truth_altered_pwclo),
    ("pointnet2-semseg-train-b32", "state unchanged", _state_unchanged_semseg),
    ("pointnet2-semseg-train-b32", "half of the batch", _half_batch_semseg),
    ("pwclonet-odometry-seq32", "an answer altered", _answer_altered),
]


@pytest.mark.parametrize("name,fault,plant", FAULTS, ids=[f"{n}: {f}" for n, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(name, fault, plant, monkeypatch):
    plant(monkeypatch)
    result = _run(name)
    assert not result["correct"], (fault, result["checks"])


# ---------------------------------------------------------------- control


@pytest.mark.parametrize("name", list(CONTROL))
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    driver = cell.driver.Driver(cell.config, cell.workload, SEED, CPU)
    driver.setup()
    runner.measure(driver, 0.3, CPU)
    driver.free()
    readings = driver.control_readings(CONTROL[name])
    assert not compare.judge(readings, cell.workload["limits"]), readings
