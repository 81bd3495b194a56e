"""The torch CLI entry points on the CPU: ``run_slam_torch.py`` (synthetic
data at 1024 points, 6 frames; ICP, CT-ICP elastic and rigid, then PWCLO-Net
and PoseResNet from checkpoints of the port's trainers), then
``replay_slam_torch.py`` on its run directory. The
result files are read back with the reference's readers. The options of
``run_slam.py`` the port does not run yet raise ``NotImplementedError``
naming their ROADMAP item."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import replay_slam_torch
import run_slam_torch
import train_net_torch
from pwclonet_pylidarslam_torch.utils.config import parse_cli
from pwclonet_pylidarslam_tpu.evaluation.results import read_metrics_yaml, read_poses_txt

REPO = Path(__file__).resolve().parents[1]
COMMON = ["dataset=synthetic", "sequences=0", "device=cpu", "num_points=1024",
          "synthetic_frames=6"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These runs' many small tensor ops on one thread: with several test
    workers on one machine, torch's thread pool per worker oversubscribes
    the cores and slows every worker."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_then_replay(tmp_path, capsys):
    run = tmp_path / "run"
    assert run_slam_torch.main(COMMON + [f"log_dir={run}", "with_backend=true",
                                         "with_loop_closure=true"]) == 0
    assert "synth00: t_rel=" in capsys.readouterr().out
    assert read_poses_txt(str(run / "synth00.poses.txt")).shape == (6, 4, 4)
    assert "ATE" in read_metrics_yaml(str(run / "metrics.yaml"))["synth00"]
    saved = yaml.safe_load((run / "config.yaml").read_text())["config"]
    assert saved["device"] == "cpu" and saved["num_points"] == 1024 and saved["with_backend"]

    assert replay_slam_torch.main([str(run), "start=1", "length=3"]) == 0
    assert "synth00: ATE=" in capsys.readouterr().out
    assert read_poses_txt(str(run / "replay" / "synth00.poses.txt")).shape == (3, 4, 4)
    assert replay_slam_torch.main([]) == 2  # the usage


def test_run_with_a_pwclonet_checkpoint(tmp_path):
    from pwclonet_pylidarslam_torch.models import scaled_model_config
    from pwclonet_pylidarslam_torch.train.state import TrainConfig
    from pwclonet_pylidarslam_torch.train.trainer import PWCLONetTrainer, TrainerConfig

    ckpt = tmp_path / "train"
    trainer = PWCLONetTrainer(TrainerConfig(
        train=TrainConfig(model=scaled_model_config(256, fused_eval=True)), log_dir=str(ckpt)),
        device="cpu")
    trainer.save_checkpoint()
    run = tmp_path / "run"
    argv = [a for a in COMMON if not a.startswith("num_points")] + [
        "num_points=256", "odometry=pwclonet", f"checkpoint_dir={ckpt}", "fused_eval=true",
        f"log_dir={run}", "synthetic_frames=4"]
    assert run_slam_torch.main(argv) == 0
    poses = read_poses_txt(str(run / "synth00.poses.txt"))
    assert poses.shape == (4, 4, 4) and np.all(np.isfinite(poses))
    np.testing.assert_array_equal(poses[0], np.eye(4))


@pytest.mark.parametrize("odometry", ["ct_icp", "ct_icp_rigid"])
def test_run_with_ct_icp(tmp_path, odometry):
    """odometry=ct_icp|ct_icp_rigid through the pipeline with loop closure
    and the back end on (a CT-ICP state has no ``pose``: the back end's
    resync leaves it as the reference does)."""
    run = tmp_path / "run"
    argv = COMMON + [f"odometry={odometry}", f"log_dir={run}", "with_backend=true",
                     "with_loop_closure=true"]
    assert run_slam_torch.main(argv) == 0
    poses = read_poses_txt(str(run / "synth00.poses.txt"))
    assert poses.shape == (6, 4, 4) and np.all(np.isfinite(poses))
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    odo = run_slam_torch.make_odometry(parse_cli(run_slam_torch.RunConfig, argv), None)
    assert odo.config.elastic == (odometry == "ct_icp") and odo.config.num_points == 1024


def test_run_with_a_posenet_checkpoint(tmp_path):
    from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
    from pwclonet_pylidarslam_torch.train.posenet_state import PoseNetTrainConfig
    from pwclonet_pylidarslam_torch.train.posenet_trainer import (
        PoseNetTrainer,
        PoseNetTrainerConfig,
    )

    ckpt = tmp_path / "train"
    proj = SphericalProjector(height=16, width=64)
    PoseNetTrainer(PoseNetTrainerConfig(train=PoseNetTrainConfig(projector=proj),
                                        log_dir=str(ckpt)), device="cpu").save_checkpoint()
    run = tmp_path / "run"
    argv = COMMON + ["odometry=posenet", f"checkpoint_dir={ckpt}", "vm_height=16", "vm_width=64",
                     f"log_dir={run}", "synthetic_frames=4"]
    assert run_slam_torch.main(argv) == 0
    poses = read_poses_txt(str(run / "synth00.poses.txt"))
    assert poses.shape == (4, 4, 4) and np.all(np.isfinite(poses))
    np.testing.assert_array_equal(poses[0], np.eye(4))
    with pytest.raises(SystemExit, match="checkpoint_dir"):
        run_slam_torch.main(COMMON + ["odometry=posenet", f"log_dir={run}"])


@pytest.mark.parametrize("preset", ["kitti_ct_icp", "kitti_posenet", "train_posenet"])
def test_presets_are_accepted(preset):
    if preset.startswith("train"):
        config = parse_cli(train_net_torch.Config, [f"config={preset}"])
        train_net_torch._check_ported(config)
        assert config.model == "posenet" and (config.vm_height, config.vm_width) == (64, 720)
        return
    config = parse_cli(run_slam_torch.RunConfig, [f"config={preset}"])
    run_slam_torch.check_ported(config)
    assert config.odometry in ("ct_icp", "posenet") and config.dataset == "kitti"


@pytest.mark.parametrize("option,item", [
    ("dataset=kitti360", "ROADMAP Queue A 9"), ("dataset=nclt", "ROADMAP Queue A 9"),
    ("dataset=rosbag", "ROADMAP Queue A 9"), ("dataset=kitti_carla", "ROADMAP Queue A 9"),
    ("dataset=urbanloco", "ROADMAP Queue A 9"), ("batched=true", "ROADMAP Queue A 9"),
    ("gallery=true", "ROADMAP Queue A 11"), ("profile_dir=prof", "ROADMAP Queue A 9"),
])
def test_unported_options_raise(tmp_path, option, item):
    with pytest.raises(NotImplementedError, match=item):
        run_slam_torch.main(COMMON + [option, f"log_dir={tmp_path}"])


def test_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    argv = [a for a in COMMON if a != "device=cpu"] + [f"log_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam_torch.main(argv)


def test_scripts_run_as_programs(tmp_path):
    """The two files run as scripts from the repository root, as a user
    calls them."""
    run = subprocess.run(
        [sys.executable, str(REPO / "run_slam_torch.py"), *COMMON, "synthetic_frames=3",
         f"log_dir={tmp_path}"], capture_output=True, text=True, cwd=REPO, timeout=600)
    assert run.returncode == 0, run.stderr
    run = subprocess.run([sys.executable, str(REPO / "replay_slam_torch.py")],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert run.returncode == 2 and "Usage" in run.stdout


def test_train_net_torch_posenet_train_then_test(tmp_path, capsys):
    """model=posenet: train on the synthetic pairs at 16×64, then the test
    mode's result files, which the reference's readers read."""
    common = ["model=posenet", "dataset=synthetic", "device=cpu", "vm_height=16", "vm_width=64",
              f"log_dir={tmp_path}"]
    assert train_net_torch.main(common + ["do_train=true", "num_epochs=1", "batch_size=2",
                                          "synthetic_batches=1"]) == 0
    assert "done: epoch 0" in capsys.readouterr().out
    assert (tmp_path / "history.jsonl").exists() and (tmp_path / "config.yaml").exists()
    assert train_net_torch.main(common + ["do_test=true", "test_sequences=9",
                                          "num_points=1024"]) == 0
    assert "seq 09:" in capsys.readouterr().out
    assert read_poses_txt(str(tmp_path / "test" / "09.poses.txt")).shape == (16, 4, 4)
    assert "ATE" in read_metrics_yaml(str(tmp_path / "test" / "metrics.yaml"))["09"]


@pytest.mark.parametrize("option,item", [
    ("model=cls", "ROADMAP Queue A 8"), ("model=semseg", "ROADMAP Queue A 8"),
    ("dataset=synthetic_world", "ROADMAP Queue A 9"), ("dataset=kitti360", "ROADMAP Queue A 9"),
])
def test_train_net_torch_unported_options_raise(tmp_path, option, item):
    with pytest.raises(NotImplementedError, match=item):
        train_net_torch.main(["do_train=true", option, f"log_dir={tmp_path}", "device=cpu"])
