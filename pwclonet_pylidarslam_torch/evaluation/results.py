"""Results persistence: metrics.yaml, pose files, trajectory plots, benchmark
tables.

The port's own copy of ``pwclonet_pylidarslam_tpu/evaluation/results.py``
(numpy only): per-sequence pose txt files (KITTI 3×4 rows), ``metrics.yaml``
in the reference's hand-written schema, trajectory PNGs, the devkit report
and a markdown benchmark aggregator. Every plot is best effort, as the
reference's ``add_sequence`` makes its plots: without a working matplotlib
the text files are written and the images are not.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from pwclonet_pylidarslam_torch.evaluation import metrics as metrics_mod


def write_poses_txt(path: str, poses: np.ndarray):
    """KITTI format: N rows of the flattened 3×4 (ref io.py / KITTI360_IO)."""
    np.savetxt(path, poses[:, :3, :4].reshape(len(poses), 12))


def read_poses_txt(path: str) -> np.ndarray:
    flat = np.loadtxt(path).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(flat), 1, 1))
    poses[:, :3, :4] = flat.reshape(-1, 3, 4)
    return poses


def write_metrics_yaml(path: str, metrics_by_sequence: Dict[str, Dict[str, float]]):
    """Schema identical to ref ``eval_odometry.save_metrics:750-759``."""
    lines = []
    for seq, md in metrics_by_sequence.items():
        lines.append(f"{seq}:")
        for k, v in md.items():
            lines.append(f"  {k}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_metrics_yaml(path: str) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    current = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            if not line.startswith(" "):
                current = line.strip().rstrip(":")
                out[current] = {}
            else:
                k, v = line.strip().split(":", 1)
                out[current][k.strip()] = float(v)
    return out


def plot_trajectories(
    path: str,
    predicted: np.ndarray,
    ground_truth: Optional[np.ndarray] = None,
    title: str = "trajectory",
):
    """Top-down (x, y) trajectory PNG (ref ``draw_trajectory_files:150``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(predicted[:, 0, 3], predicted[:, 1, 3], label="prediction", lw=1.2)
    if ground_truth is not None:
        ax.plot(
            ground_truth[:, 0, 3], ground_truth[:, 1, 3],
            label="ground truth", lw=1.2, ls="--",
        )
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_segment_errors(
    path: str, predicted: np.ndarray, ground_truth: np.ndarray, title: str = ""
):
    """Per-segment-length and per-speed error plots (the KITTI devkit panels,
    ref ``evaluation.py:236-500``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    errors = metrics_mod.calc_sequence_errors(predicted, ground_truth)
    if not errors:
        return False
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    segs = sorted({e["segment"] for e in errors})

    def seg_avg(key):
        return [
            float(np.mean([e[key] for e in errors if e["segment"] == s])) for s in segs
        ]

    axes[0, 0].plot(segs, [100 * v for v in seg_avg("tr_err")], "o-")
    axes[0, 0].set_xlabel("segment length (m)")
    axes[0, 0].set_ylabel("translation error (%)")
    axes[0, 1].plot(segs, [np.rad2deg(v) * 100 for v in seg_avg("r_err")], "o-")
    axes[0, 1].set_xlabel("segment length (m)")
    axes[0, 1].set_ylabel("rotation error (deg/100m)")

    speeds = np.asarray([e["speed"] * 3.6 for e in errors])  # km/h
    bins = np.linspace(speeds.min(), speeds.max() + 1e-6, 8)
    centers = 0.5 * (bins[1:] + bins[:-1])
    idx = np.clip(np.digitize(speeds, bins) - 1, 0, len(centers) - 1)
    tr = np.asarray([100 * e["tr_err"] for e in errors])
    rot = np.asarray([np.rad2deg(e["r_err"]) * 100 for e in errors])
    tr_by_speed = [tr[idx == b].mean() if (idx == b).any() else np.nan for b in range(len(centers))]
    rot_by_speed = [rot[idx == b].mean() if (idx == b).any() else np.nan for b in range(len(centers))]
    axes[1, 0].plot(centers, tr_by_speed, "o-")
    axes[1, 0].set_xlabel("speed (km/h)")
    axes[1, 0].set_ylabel("translation error (%)")
    axes[1, 1].plot(centers, rot_by_speed, "o-")
    axes[1, 1].set_xlabel("speed (km/h)")
    axes[1, 1].set_ylabel("rotation error (deg/100m)")
    fig.suptitle(title or "segment errors")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def to_camera_coord(poses: np.ndarray) -> np.ndarray:
    """Lidar-frame → KITTI camera-frame trajectory (ref ``evaluation.py:140-151``:
    conjugation by the fixed camera↔lidar axis permutation)."""
    R_C2L = np.array(
        [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
    )
    return np.linalg.inv(R_C2L) @ poses @ R_C2L


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_xyz(path, predicted, ground_truth=None, title=""):
    """Per-frame x/y/z component plot, GT vs prediction
    (ref ``evaluation.py:292-329``)."""
    plt = _plt()
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for k, name in enumerate("xyz"):
        if ground_truth is not None:
            axes[k].plot(ground_truth[:, k, 3], color="black", label="GT")
        axes[k].plot(predicted[:, k, 3], color="tab:blue", ls="--", label="prediction")
        axes[k].set_ylabel(f"{name} (m)")
    axes[2].set_xlabel("frame")
    axes[0].legend()
    fig.suptitle(title or "xyz")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_rpy(path, predicted, ground_truth=None, title=""):
    """Per-frame roll/pitch/yaw plot (ref ``evaluation.py:332-370``; euler
    extraction via scipy, fixed-axes xyz)."""
    from scipy.spatial.transform import Rotation

    plt = _plt()

    def rpy(poses):
        return Rotation.from_matrix(poses[:, :3, :3]).as_euler("xyz", degrees=True)

    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    pred_e = rpy(predicted)
    gt_e = rpy(ground_truth) if ground_truth is not None else None
    for k, name in enumerate(("roll", "pitch", "yaw")):
        if gt_e is not None:
            axes[k].plot(np.unwrap(gt_e[:, k], period=360), color="black", label="GT")
        axes[k].plot(
            np.unwrap(pred_e[:, k], period=360), color="tab:blue", ls="--",
            label="prediction",
        )
        axes[k].set_ylabel(f"{name} (deg)")
    axes[2].set_xlabel("frame")
    axes[0].legend()
    fig.suptitle(title or "rpy")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_path_2d_3(path, predicted, ground_truth=None, title=""):
    """The devkit's three planar path views xy / xz / yz
    (ref ``plotPath_2D_3``, ``evaluation.py:373-452``)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    planes = ((0, 1, "x", "y"), (0, 2, "x", "z"), (1, 2, "y", "z"))
    for ax, (i, j, ni, nj) in zip(axes, planes):
        if ground_truth is not None:
            ax.plot(ground_truth[:, i, 3], ground_truth[:, j, 3], color="black", label="GT")
        ax.plot(predicted[:, i, 3], predicted[:, j, 3], color="tab:blue", ls="--", label="prediction")
        ax.set_xlabel(f"{ni} (m)")
        ax.set_ylabel(f"{nj} (m)")
        ax.set_aspect("equal", adjustable="datalim")
    axes[0].legend()
    fig.suptitle(title or "path")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_path_3d(path, predicted, ground_truth=None, title=""):
    """3D path plot (ref ``plotPath_3D``, ``evaluation.py:455-512``)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    if ground_truth is not None:
        ax.plot(
            ground_truth[:, 0, 3], ground_truth[:, 1, 3], ground_truth[:, 2, 3],
            color="black", label="GT",
        )
    ax.plot(
        predicted[:, 0, 3], predicted[:, 1, 3], predicted[:, 2, 3],
        color="tab:blue", ls="--", label="prediction",
    )
    ax.legend()
    ax.set_title(title or "path 3D")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def save_sequence_errors(path, errors):
    """Whitespace rows ``first_frame r_err tr_err segment speed`` — the
    devkit's ``saveSequenceErrors`` (``evaluation.py:273-279``)."""
    with open(path, "w") as f:
        for e in errors:
            f.write(
                f"{e['first_frame']} {e['r_err']} {e['tr_err']} "
                f"{e['segment']} {e['speed']}\n"
            )


def _best_effort(plot, *args, **kwargs) -> None:
    try:
        plot(*args, **kwargs)
    except Exception:
        pass  # plotting is best-effort (headless/broken/missing matplotlib)


def write_devkit_report(
    out_dir: str,
    sequence_name: str,
    predicted: np.ndarray,
    ground_truth: Optional[np.ndarray] = None,
    to_camera: bool = False,
) -> Optional[Dict[str, float]]:
    """Full per-sequence devkit artifact set (ref ``kittiOdomEval.eval``,
    ``evaluation.py:644-721``): xyz/rpy plots, 2D-planes + 3D path plots,
    segment/speed error plots, the raw per-segment error txt and a stats txt
    with the overall averages. Returns ``{"ave_t_err", "ave_r_err"}``
    (fraction, rad/m) when GT is available."""
    os.makedirs(out_dir, exist_ok=True)
    if to_camera:
        predicted = to_camera_coord(predicted)
        if ground_truth is not None:
            ground_truth = to_camera_coord(ground_truth)
    p = lambda name: os.path.join(out_dir, f"{sequence_name}_{name}")
    for plot, name in ((plot_xyz, "xyz.png"), (plot_rpy, "rpy.png"),
                       (plot_path_2d_3, "path_2d.png"), (plot_path_3d, "path_3d.png")):
        _best_effort(plot, p(name), predicted, ground_truth, title=sequence_name)
    if ground_truth is None:
        return None
    errors = metrics_mod.calc_sequence_errors(predicted, ground_truth)
    save_sequence_errors(p("error.txt"), errors)
    _best_effort(plot_segment_errors, p("errors.png"), predicted, ground_truth,
                 title=sequence_name)
    if not errors:
        return None
    ave_t = float(np.mean([e["tr_err"] for e in errors]))
    ave_r = float(np.mean([e["r_err"] for e in errors]))
    with open(os.path.join(out_dir, "all_stats.txt"), "a") as f:
        f.write(
            f"seq{sequence_name} Average_t_error {ave_t * 100:.2f} "
            f"Average_r_error {np.rad2deg(ave_r) * 100:.2f}\n"
        )
    return {"ave_t_err": ave_t, "ave_r_err": ave_r}


class OdometryResults:
    """Per-run results directory (ref ``OdometryResults``).

    Layout::

        <log_dir>/
          <seq>.poses.txt       predicted absolute poses
          <seq>_gt.poses.txt    ground truth (if available)
          <seq>.png             trajectory plot
          metrics.yaml          per-sequence metric dict
    """

    _FRAME_GAP_M = 100.0  # incremental metric cadence (ref eval_odometry.py:_FRAME_GAP)

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.metrics: Dict[str, Dict[str, float]] = {}
        self._incremental_done: Dict[str, int] = {}  # name -> milestones logged

    def add_frames(
        self,
        sequence_name: str,
        predicted: np.ndarray,
        ground_truth: np.ndarray,
    ) -> Optional[Dict[str, float]]:
        """Incremental evaluation: every time the ground-truth trajectory
        crosses another 100 m of travel, append a metric record (t_rel/ATE/
        ARE over the trajectory SO FAR) to ``<seq>.incremental.jsonl`` —
        the continuous regression signal of the reference
        (``eval_odometry.py:539-654``; invoked from
        ``odometry_runner.py:255-263``). Returns the newest record or None
        if no new milestone was crossed."""
        import json

        n = min(len(predicted), len(ground_truth))
        if n < 2:
            return None
        dist = metrics_mod.trajectory_distances(ground_truth[:n])
        milestones = int(dist[-1] // self._FRAME_GAP_M)
        done = self._incremental_done.get(sequence_name, 0)
        if milestones <= done:
            return None
        md = metrics_mod.metrics_dict(predicted[:n], ground_truth[:n])
        record = {
            "frames": int(n),
            "distance_m": float(dist[-1]),
            **{k: v for k, v in md.items() if isinstance(v, (int, float))},
        }
        path = os.path.join(self.log_dir, f"{sequence_name}.incremental.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self._incremental_done[sequence_name] = milestones
        return record

    def add_sequence(
        self,
        sequence_name: str,
        predicted: np.ndarray,
        ground_truth: Optional[np.ndarray] = None,
        elapsed_seconds: Optional[float] = None,
        plot: bool = True,
        mode: str = "normal",
    ) -> Optional[Dict[str, float]]:
        """``mode``: evaluation mode (ref ``add_sequence(mode=...)``) —
        ``normal`` / ``rescale_simple`` / ``eval_rotation`` / ``eval_translation``."""
        write_poses_txt(
            os.path.join(self.log_dir, f"{sequence_name}.poses.txt"), predicted
        )
        md = None
        if ground_truth is not None:
            write_poses_txt(
                os.path.join(self.log_dir, f"{sequence_name}_gt.poses.txt"),
                ground_truth,
            )
            nspf = (
                elapsed_seconds / len(predicted) * 1e9
                if elapsed_seconds is not None
                else None
            )
            md = metrics_mod.metrics_dict(
                predicted, ground_truth, nsecs_per_frame=nspf, mode=mode
            )
            self.metrics[sequence_name] = md
            write_metrics_yaml(os.path.join(self.log_dir, "metrics.yaml"), self.metrics)
        if plot:
            try:
                plot_trajectories(
                    os.path.join(self.log_dir, f"{sequence_name}.png"),
                    predicted,
                    ground_truth,
                    title=sequence_name,
                )
                if ground_truth is not None:
                    plot_segment_errors(
                        os.path.join(self.log_dir, f"{sequence_name}_errors.png"),
                        predicted,
                        ground_truth,
                        title=sequence_name,
                    )
            except Exception:
                pass  # plotting is best-effort (headless/broken matplotlib)
        return md


def build_benchmark_md(result_dirs: List[str], out_path: str, dataset_name: str = "KITTI"):
    """Aggregate ``metrics.yaml`` files into a ranked markdown table
    (ref ``build_benchmark_md.py:52-196``)."""
    rows = []
    for d in result_dirs:
        ypath = os.path.join(d, "metrics.yaml")
        if not os.path.exists(ypath):
            continue
        per_seq = read_metrics_yaml(ypath)
        if not per_seq:
            continue
        avg_tr = float(np.mean([m.get("tr_err", np.nan) for m in per_seq.values()]))
        avg_rot = float(np.mean([m.get("rot_err", np.nan) for m in per_seq.values()]))
        ms = [
            m["nsecs_per_frame"] / 1e6
            for m in per_seq.values()
            if "nsecs_per_frame" in m
        ]
        rows.append(
            {
                "name": os.path.basename(os.path.normpath(d)),
                "tr_err": avg_tr,
                "rot_err": avg_rot,
                "ms_per_frame": float(np.mean(ms)) if ms else float("nan"),
                "sequences": ", ".join(per_seq.keys()),
            }
        )
    rows.sort(key=lambda r: r["tr_err"])
    lines = [
        f"# {dataset_name} benchmark",
        "",
        "| run | avg t_rel (%) | avg r_rel (deg/100m) | ms/frame | sequences |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['tr_err']:.4f} | {r['rot_err']:.4f} | "
            f"{r['ms_per_frame']:.1f} | {r['sequences']} |"
        )
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return rows
