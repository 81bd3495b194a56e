"""The torch CLI entry points on the CPU: ``run_slam_torch.py`` (synthetic
data at 1024 points, 6 frames; ICP, CT-ICP elastic and rigid, then PWCLO-Net
and PoseResNet from checkpoints of the port's trainers), then
``replay_slam_torch.py`` on its run directory; ``batched=true``, its
refusals and ``config=kitti_batched``; ``profile_dir`` in both CLIs; every
dataset of ``run_slam.py`` (the presets ``nclt_voxel``, ``nhcd_voxel``,
``urbanloco_gps`` and ``kitti_carla_ct_icp`` among them) on files written
under the test's tmp dir (``tools/dataset_files.py``, 5 frames of 1024
points), ``gallery=true``, and ``train_net_torch.py dataset=kitti360``. The
result files are read back with the reference's readers."""

import json
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
from tools import dataset_files as df

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


PRESETS = {"kitti_ct_icp": ("kitti", "ct_icp"), "kitti_posenet": ("kitti", "posenet"),
           "nclt_voxel": ("nclt", "icp"), "nhcd_voxel": ("nhcd", "icp"),
           "urbanloco_gps": ("urbanloco", "icp"), "kitti_carla_ct_icp": ("kitti_carla", "ct_icp")}


@pytest.mark.parametrize("preset", [*PRESETS, "train_posenet"])
def test_presets_are_accepted(preset):
    if preset.startswith("train"):
        config = parse_cli(train_net_torch.Config, [f"config={preset}"])
        train_net_torch._check_config(config)
        assert config.model == "posenet" and (config.vm_height, config.vm_width) == (64, 720)
        return
    config = parse_cli(run_slam_torch.RunConfig, [f"config={preset}"])
    run_slam_torch.check_config(config)
    assert (config.dataset, config.odometry) == PRESETS[preset] and config.num_points == 8192


@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    """Five corridor frames of 1024 points in every format of the datasets,
    with ``run_slam_torch.py``'s dataset, root_dir and sequences for each."""
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence_with_times,
    )

    scans, alphas, poses = generate_sequence_with_times(
        SyntheticSequenceConfig(n_frames=5, num_points=1024, seed=2), device="cpu")
    root = tmp_path_factory.mktemp("datasets")
    layout = df.write_all(str(root), scans, poses, alphas)
    return {name: [f"dataset={name}", f"root_dir={root / sub}", f"sequences={seq}"]
            for name, (sub, seq) in layout.items()}


# each dataset of run_slam.py with its sequence's name, the four presets run
# where they name the dataset. urbanloco_gps optimizes the back end at every
# GPS fix, each ~3 s on this CPU (CG runs to its 500 iterations, as in the
# reference), so it runs over the bag's first 2 frames
DATASET_RUNS = {
    "kitti360": ("00", []), "nclt": ("2012-01-08", ["config=nclt_voxel"]),
    "ford": ("dataset-1", []), "nhcd": ("01_short_experiment", ["config=nhcd_voxel"]),
    "rosbag": ("drive", ["rosbag_topic=/velodyne_points"]),
    "urbanloco": ("CA-drive", ["config=urbanloco_gps", "max_frames=2"]),
    "ply_dir": ("frames", []), "kitti_carla": ("Town01", ["config=kitti_carla_ct_icp"]),
}


@pytest.mark.parametrize("dataset", DATASET_RUNS)
def test_every_dataset_runs(tmp_path, capsys, dataset_files, dataset):
    """``run_slam_torch.py`` over the written files of each dataset: finite
    poses from the identity, and, where the format holds ground truth (all
    but a plain rosbag), the metrics the reference's readers read."""
    name, extra = DATASET_RUNS[dataset]
    argv = [*extra, *dataset_files[dataset], "device=cpu", "num_points=1024",
            f"log_dir={tmp_path}"]
    assert run_slam_torch.main(argv) == 0
    poses = read_poses_txt(str(tmp_path / f"{name}.poses.txt"))
    assert poses.shape == (2 if "max_frames=2" in extra else 5, 4, 4)
    assert np.all(np.isfinite(poses))
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    has_gt = dataset != "rosbag"
    assert (f"{name}: t_rel=" in capsys.readouterr().out) == has_gt
    metrics = tmp_path / "metrics.yaml"
    assert has_gt == (metrics.exists() and "ATE" in read_metrics_yaml(str(metrics))[name])


def test_gallery_runs(tmp_path):
    """gallery=true writes each sequence's gallery and player (the
    reference's ``tests/test_cli.py::test_run_slam_gallery``)."""
    assert run_slam_torch.main(COMMON + [f"log_dir={tmp_path}", "gallery=true"]) == 0
    gal = tmp_path / "synth00_gallery"
    page = (gal / "index.html").read_text()
    assert "Trajectory" in page and "frame 0" in page and "player.html" in page
    for f in ("path_2d.png", "path_3d.png", "xyz.png", "rpy.png"):
        assert (gal / f).exists(), f
    assert len(list(gal.glob("frame_*_vm.png"))) == len(list(gal.glob("frame_*_bev.png"))) == 6
    player = (gal / "player.html").read_text()
    assert "<canvas" in player and "drag" in player and player.count("worldPts") >= 2
    assert "http" not in player.split("<script>")[1]
    data = json.loads(player.split("const D = ", 1)[1].split(";\nconst T")[0])
    assert len(data["frames"]) == 6 and len(data["poses"]) == 6


def test_batched_run_equals_the_library(tmp_path, capsys):
    """batched=true over two synthetic sequences: the reference's result
    files, and the poses of BatchedICPOdometry on the same scans."""
    from pwclonet_pylidarslam_torch.data.synthetic import (
        SyntheticSequenceConfig,
        generate_sequence,
    )
    from pwclonet_pylidarslam_torch.slam import BatchedICPOdometry, ICPConfig
    from pwclonet_pylidarslam_torch.slam.icp_odometry import fix_scan_size

    run = tmp_path / "run"
    argv = ["batched=true", "dataset=synthetic", "sequences=0,1", "synthetic_frames=8",
            "num_points=1024", "device=cpu", f"log_dir={run}"]
    assert run_slam_torch.main(argv) == 0
    out = capsys.readouterr().out
    assert "synth00: t_rel=" in out and "synth01: t_rel=" in out
    metrics = read_metrics_yaml(str(run / "metrics.yaml"))
    assert set(metrics) == {"synth00", "synth01"} and all("ATE" in m for m in metrics.values())
    scans = [generate_sequence(SyntheticSequenceConfig(n_frames=8, seed=s, num_points=1024),
                               device="cpu")[0] for s in (0, 1)]
    odo = BatchedICPOdometry(ICPConfig(num_points=1024), device="cpu")
    odo.init(n_sequences=2)
    odo.process_chunk(np.stack([[fix_scan_size(sc[t], 1024, seed=t) for t in range(8)]
                                for sc in scans]))
    for i, name in enumerate(("synth00", "synth01")):
        rows = np.loadtxt(run / f"{name}.poses.txt")
        assert rows.shape == (8, 12)
        np.testing.assert_array_equal(read_poses_txt(str(run / f"{name}.poses.txt")),
                                      odo.absolute_poses()[i].astype(np.float64))


@pytest.mark.parametrize("option", ["with_backend=true", "with_loop_closure=true", "gps=true",
                                    "snapshot_every_frames=5", "odometry=ct_icp"])
def test_batched_keeps_the_references_refusals(tmp_path, option):
    with pytest.raises(SystemExit, match="batched=true"):
        run_slam_torch.main(COMMON + ["batched=true", option, f"log_dir={tmp_path}"])


def test_kitti_batched_preset_parses():
    config = parse_cli(run_slam_torch.RunConfig, ["config=kitti_batched", "dataset=synthetic"])
    run_slam_torch.check_config(config)
    assert config.batched and config.odometry == "icp" and config.num_points == 8192
    assert config.sequences == "0,1,2,3,4,5,6,7,8,9,10"


@pytest.mark.parametrize("entry", ["run_slam_torch", "run_slam_torch_batched", "train_net_torch"])
def test_profile_dir_writes_a_trace(tmp_path, entry):
    prof = tmp_path / "prof"
    if entry == "train_net_torch":
        assert train_net_torch.main([
            "do_train=true", "dataset=synthetic_world", "device=cpu", "num_points=256",
            "synthetic_frames=3", "num_epochs=1", "batch_size=2", "train_sequences=0",
            "eval_sequences=0", f"log_dir={tmp_path / 'train'}", f"profile_dir={prof}"]) == 0
    else:
        batched = ["batched=true"] if entry.endswith("batched") else []
        assert run_slam_torch.main(COMMON + batched + [
            "synthetic_frames=3", f"log_dir={tmp_path / 'run'}", f"profile_dir={prof}"]) == 0
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    assert '"traceEvents"' in traces[0].read_text()


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


def test_train_net_torch_kitti360_train_then_test(tmp_path, capsys, dataset_files):
    """dataset=kitti360: one epoch on the written drive's pairs at 1024
    points, then the fused test mode on it writes the reference's result
    files."""
    root = dataset_files["kitti360"][1]
    common = ["dataset=kitti360", root, "device=cpu", "num_points=1024", f"log_dir={tmp_path}"]
    assert train_net_torch.main(common + ["do_train=true", "num_epochs=1", "batch_size=2",
                                          "train_sequences=0", "eval_sequences=0"]) == 0
    assert "done: epoch 0" in capsys.readouterr().out
    record = json.loads((tmp_path / "history.jsonl").read_text().splitlines()[0])
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["eval_loss"])
    assert train_net_torch.main(common + ["do_test=true", "test_sequences=0",
                                          "fused_eval=true"]) == 0
    assert "seq 00:" in capsys.readouterr().out
    assert read_poses_txt(str(tmp_path / "test" / "00.poses.txt")).shape == (5, 4, 4)
    assert "ATE" in read_metrics_yaml(str(tmp_path / "test" / "metrics.yaml"))["00"]


def test_train_net_torch_synthetic_world_train_then_test(tmp_path, capsys):
    """dataset=synthetic_world (formerly refused): one train step on the
    pairs of a 3-frame KITTI-profile world at 256 points, then the test mode
    on a held-out world writes the reference's result files."""
    common = ["dataset=synthetic_world", "device=cpu", "num_points=256", "synthetic_frames=3",
              f"log_dir={tmp_path}"]
    assert train_net_torch.main(common + ["do_train=true", "num_epochs=1", "batch_size=2",
                                          "train_sequences=0", "eval_sequences=0"]) == 0
    assert "done: epoch 0" in capsys.readouterr().out
    record = json.loads((tmp_path / "history.jsonl").read_text().splitlines()[0])
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["eval_loss"])
    assert train_net_torch.main(common + ["do_test=true", "test_sequences=9"]) == 0
    assert "seq 09:" in capsys.readouterr().out
    assert read_poses_txt(str(tmp_path / "test" / "09.poses.txt")).shape == (3, 4, 4)
    assert "ATE" in read_metrics_yaml(str(tmp_path / "test" / "metrics.yaml"))["09"]
