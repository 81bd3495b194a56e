"""The torch CLI entry points on the CPU: ``run_slam_torch.py`` (synthetic
data at 1024 points, 6 frames; ICP, then PWCLO-Net from a checkpoint of the
port's trainer), then ``replay_slam_torch.py`` on its run directory. The
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
from pwclonet_pylidarslam_tpu.evaluation.results import read_metrics_yaml, read_poses_txt

REPO = Path(__file__).resolve().parents[1]
COMMON = ["dataset=synthetic", "sequences=0", "device=cpu", "num_points=1024",
          "synthetic_frames=6"]


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


@pytest.mark.parametrize("option,item", [
    ("dataset=kitti360", "ROADMAP Queue A 9"), ("dataset=nclt", "ROADMAP Queue A 9"),
    ("dataset=rosbag", "ROADMAP Queue A 9"), ("odometry=ct_icp", "ROADMAP Queue A 6"),
    ("odometry=posenet", "ROADMAP Queue A 7"), ("batched=true", "ROADMAP Queue A 9"),
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
