"""The port's trainer (``pwclonet_pylidarslam_torch/train/trainer.py``) and
its entry ``train_net_torch.py`` on the CPU at a small config: the epoch
loop and its records, the checkpoint round trip, the trained state in the
odometry, the command line, and a reference checkpoint carried across by
``tools/export_flax_checkpoint.py``."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.models import PWCLONet, PWCLONetConfig, load_flax_variables
from pwclonet_pylidarslam_torch.models.convert import load_flax_npz
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
from pwclonet_pylidarslam_torch.train.state import TrainConfig
from pwclonet_pylidarslam_torch.train.trainer import AverageMeter, PWCLONetTrainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
SMALL = PWCLONetConfig(num_points=128, sa_npoints=(32, 16, 8, 4), sa_nsamples=(8, 8, 4, 4))


def make_batches(n_batches=2, batch_size=2, n=128, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pts1 = r.normal(size=(batch_size, n, 3)).astype(np.float32) * 8
        twists = (r.normal(size=(batch_size, 6)) * 0.05).astype(np.float32)
        pose = se3.exp(torch.from_numpy(twists))
        pts2 = se3.transform(pose, torch.from_numpy(pts1)).numpy()
        gt = se3.pose_to_params_quat(pose).numpy().astype(np.float32)
        out.append({"xyz1": pts1, "xyz2": pts2, "gt_params": gt})
    return out


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    cfg = TrainerConfig(
        train=TrainConfig(model=SMALL, total_steps=50),
        num_epochs=2,
        log_dir=str(tmp_path_factory.mktemp("train")),
        checkpoint_every_epochs=0,
        eval_every_epochs=1,
        steps_per_dispatch=2,
    )
    return PWCLONetTrainer(cfg, device="cpu")


def test_fit_runs_and_logs(trainer):
    batches = make_batches()
    history = trainer.fit(lambda: iter(batches), lambda: iter(batches), num_epochs=2)
    assert len(history) == 2 and trainer.epoch == 2 and trainer.state.step == 4
    assert all(np.isfinite(h["train_loss"]) for h in history)
    for key in ("eval_loss", "ATE", "ARE", "tr_err"):
        assert key in history[0]
    assert np.isfinite(history[0]["eval_loss"]) and np.isfinite(history[0]["ATE"])
    lines = open(os.path.join(trainer.config.log_dir, "history.jsonl")).readlines()
    assert len(lines) == 2 and json.loads(lines[1])["epoch"] == 1
    assert trainer.checkpoint_steps()[-1] == 4  # the final checkpoint
    meta = torch.load(trainer.checkpoint_path(4), weights_only=True)["meta"]
    assert meta["tag"] == "final" and meta["epoch"] == 2


def test_checkpoint_roundtrip(trainer):
    step_before, epoch_before = trainer.state.step, trainer.epoch
    trainer.save_checkpoint("test")
    old = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    old_moment = trainer.state.optimizer.exp_avg.clone()
    old_s = trainer.state.loss_params["s_param"].detach().clone()
    with torch.no_grad():  # corrupt: weights, statistics, loss parameter, moments, counters
        for t in trainer.model.state_dict().values():
            t.zero_()
        trainer.state.loss_params["s_param"].zero_()
        trainer.state.optimizer.exp_avg.zero_()
    trainer.state.step, trainer.epoch, trainer.best_train_loss = 99, 7, -1.0
    trainer.load_checkpoint()
    assert trainer.state.step == step_before and trainer.epoch == epoch_before
    assert trainer.best_train_loss > 0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, old[k]), k
    assert torch.equal(trainer.state.optimizer.exp_avg, old_moment)
    assert torch.equal(trainer.state.loss_params["s_param"].detach(), old_s)
    assert float(old_moment.abs().max()) > 0
    with pytest.raises(FileNotFoundError):
        trainer.load_checkpoint(step=12345)


def test_trained_state_loads_into_the_odometry(trainer):
    cfg = DeepOdometryConfig(model=SMALL, num_points=128)
    path = trainer.checkpoint_path(trainer.checkpoint_steps()[-1])
    from_path = PWCLONetOdometry(path, cfg, device="cpu")
    from_dict = PWCLONetOdometry(trainer.state.state_dict(), cfg, device="cpu", seed=5)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(from_path.model.state_dict()[k], v), k
        assert torch.equal(from_dict.model.state_dict()[k], v), k
    scans = np.random.default_rng(0).normal(size=(3, 200, 3)).astype(np.float32) * 8
    from_path.init()
    poses = from_path.process_sequence(scans)
    assert poses.shape == (3, 4, 4) and np.isfinite(poses).all()


def test_train_epoch_blocks_and_meter():
    meter = AverageMeter()
    meter.update(2.0, n=3)
    meter.update(4.0, n=1)
    assert meter.average == 2.5 and AverageMeter().average == 0.0

    class Recorder(PWCLONetTrainer):
        def __init__(self):  # no model: only the blocking of train_epoch is under test
            self.config = TrainerConfig(steps_per_dispatch=3)
            self.blocks = []

        def _train_steps(self, block):
            self.blocks.append(block["x"].shape)
            losses = [float("nan") if np.isnan(b).any() else 1.0 for b in block["x"]]
            return {"loss": torch.tensor(losses)}

    rec = Recorder()
    sizes = [2, 2, 2, 2, 4, 4, 2]
    batches = [{"x": np.zeros((b, 5), np.float32)} for b in sizes]
    batches[1]["x"][0, 0] = np.nan
    assert rec.train_epoch(iter(batches)) == 1.0  # the skipped batch is left out of the mean
    assert rec.blocks == [(3, 2, 5), (1, 2, 5), (2, 4, 5), (1, 2, 5)]


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PWCLONetTrainer(TrainerConfig(train=TrainConfig(model=SMALL), log_dir=str(tmp_path)))


def _cli(*args):
    # one torch thread, as in-process tests set: several test workers share
    # the machine's cores
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(REPO / "train_net_torch.py"), *args],
                          capture_output=True, text=True, env=env, timeout=600)


def test_train_net_torch_cli(tmp_path):
    common = ("--dataset", "synthetic", "--device", "cpu", "--num_points", "128",
              "--log_dir", str(tmp_path))
    run = _cli("--do_train", "--num_epochs", "1", "--batch_size", "2", "--synthetic_batches", "2",
               *common)
    assert run.returncode == 0, run.stderr
    assert "done: epoch 0" in run.stdout
    assert (tmp_path / "history.jsonl").exists() and (tmp_path / "config.yaml").exists()
    run = _cli("--do_test", "--test_sequences", "9", *common)
    assert run.returncode == 0, run.stderr
    assert "seq 09:" in run.stdout and "ATE=" in run.stdout
    # the result files of train_net.py's test mode, readable by the reference
    from pwclonet_pylidarslam_tpu.evaluation.results import read_metrics_yaml, read_poses_txt

    assert read_poses_txt(str(tmp_path / "test" / "09.poses.txt")).shape == (16, 4, 4)
    assert read_poses_txt(str(tmp_path / "test" / "09_gt.poses.txt")).shape == (16, 4, 4)
    assert "ATE" in read_metrics_yaml(str(tmp_path / "test" / "metrics.yaml"))["09"]
    assert (tmp_path / "test" / "09_eval" / "09_error.txt").exists()
    run = _cli("--do_train", "dataset=kitti361", "--device", "cpu")
    assert run.returncode != 0 and "unknown model/dataset" in run.stderr
    assert _cli().returncode == 2  # neither do_train nor do_test: the usage


def test_train_net_torch_cli_synthetic_world(tmp_path):
    """--dataset synthetic_world from the command line: one train step on a
    3-frame KITTI-profile world at 128 points, then --do_test --fused_eval on
    a held-out world."""
    common = ("--dataset", "synthetic_world", "--device", "cpu", "--num_points", "128",
              "--synthetic_frames", "3", "--log_dir", str(tmp_path))
    run = _cli("--do_train", "--num_epochs", "1", "--batch_size", "2", "--train_sequences", "0",
               "--eval_sequences", "0", *common)
    assert run.returncode == 0, run.stderr
    assert "done: epoch 0" in run.stdout
    run = _cli("--do_test", "--fused_eval", "--test_sequences", "9", *common)
    assert run.returncode == 0, run.stderr
    assert "seq 09:" in run.stdout
    from pwclonet_pylidarslam_tpu.evaluation.results import read_poses_txt

    assert read_poses_txt(str(tmp_path / "test" / "09.poses.txt")).shape == (3, 4, 4)
    assert read_poses_txt(str(tmp_path / "test" / "09_gt.poses.txt")).shape == (3, 4, 4)


def test_train_net_torch_cli_on_a_kitti_directory(tmp_path):
    from test_torch_data import _write_kitti

    _write_kitti(tmp_path / "kitti", n_scans=5)
    common = ("--dataset", "kitti", "--root_dir", str(tmp_path / "kitti"), "--device", "cpu",
              "--num_points", "128", "--log_dir", str(tmp_path / "out"))
    run = _cli("--do_train", "--num_epochs", "1", "--batch_size", "2", "--train_sequences", "4",
               "--eval_sequences", "4", *common)
    assert run.returncode == 0, run.stderr
    record = json.loads((tmp_path / "out" / "history.jsonl").read_text().splitlines()[0])
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["eval_loss"])
    run = _cli("--do_test", "--test_sequences", "4", *common)
    assert run.returncode == 0, run.stderr
    assert "seq 04:" in run.stdout


def test_reference_checkpoint_exports_and_loads(tmp_path):
    """A reference trainer's orbax checkpoint, written as ``.npz`` by
    ``tools/export_flax_checkpoint.py``, gives the port the reference's eval
    forward."""
    import jax
    import jax.numpy as jnp

    from pwclonet_pylidarslam_tpu.models import scaled_model_config as j_scaled
    from pwclonet_pylidarslam_tpu.train.state import TrainConfig as JTrainConfig
    from pwclonet_pylidarslam_tpu.train.trainer import PWCLONetTrainer as JTrainer
    from pwclonet_pylidarslam_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from pwclonet_pylidarslam_torch.models import scaled_model_config

    jtrainer = JTrainer(JTrainerConfig(train=JTrainConfig(model=j_scaled(128)),
                                       log_dir=str(tmp_path / "ref")))
    # running statistics away from their init, so that they matter
    bumped = jax.tree.map(lambda a: a + 0.25, jtrainer.state.batch_stats)
    jtrainer.state = jtrainer.state._replace(batch_stats=bumped)
    jtrainer.save_checkpoint("test")
    out = tmp_path / "state.npz"
    spec = importlib.util.spec_from_file_location(
        "export_flax_checkpoint", REPO / "tools" / "export_flax_checkpoint.py")
    export_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export_tool)
    assert export_tool.main(["--log_dir", str(tmp_path / "ref"), "--num_points", "128",
                             "--out", str(out)]) == 0
    tree = load_flax_npz(out)
    assert set(tree) == {"params", "batch_stats", "loss_params", "opt_state", "step"}

    rng = np.random.default_rng(0)
    x1 = (rng.normal(size=(2, 128, 3)) * 8).astype(np.float32)
    x2 = (x1 + rng.normal(size=x1.shape) * 0.05).astype(np.float32)
    ref, _ = jax.jit(lambda v, a, b: jtrainer.model.apply(v, a, b, train=False))(
        {"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats},
        jnp.asarray(x1), jnp.asarray(x2))
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    net = load_flax_variables(PWCLONet(scaled_model_config(128), device="cpu"), variables)
    with torch.inference_mode():
        params, _ = net(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(params.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    odo = PWCLONetOdometry(tree, DeepOdometryConfig(model=scaled_model_config(128), num_points=128),
                           device="cpu")
    assert torch.equal(odo.model.state_dict()["SetConv_0.PointMLP_0.var_0"],
                       net.state_dict()["SetConv_0.PointMLP_0.var_0"])
