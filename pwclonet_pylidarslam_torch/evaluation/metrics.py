"""KITTI odometry metrics: t_rel / r_rel segment errors, ATE, ARE.

A copy of ``pwclonet_pylidarslam_tpu/evaluation/metrics.py`` (numpy only),
kept here so the port imports nothing of the JAX package. The metric
definitions port the reference's ``slam/eval/eval_odometry.py:247-440`` (the
KITTI devkit): segment lengths 100..800 m, every-10th start frame,
trace-based rotation error, relative-pose ATE/ARE.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_SEGMENTS = (100, 200, 300, 400, 500, 600, 700, 800)


def compute_relative_poses(absolute: np.ndarray) -> np.ndarray:
    """Absolute ``(T,4,4)`` → relative; entry 0 = identity (ref :247-260)."""
    rel = np.einsum("tij,tjk->tik", np.linalg.inv(absolute[:-1]), absolute[1:])
    return np.concatenate([np.eye(4)[None], rel], axis=0)


def compute_absolute_poses(relative: np.ndarray) -> np.ndarray:
    """Relative ``(T,4,4)`` → absolute by prefix composition (ref :263-276)."""
    out = np.empty_like(relative)
    acc = np.eye(4)
    for t in range(relative.shape[0]):
        acc = acc @ relative[t]
        out[t] = acc
    return out


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative traveled distance along ``(T,4,4)`` (KITTI devkit)."""
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def rotation_error(pose_err: np.ndarray) -> float:
    """Angle of the error rotation via trace (ref :279-290)."""
    tr = pose_err[0, 0] + pose_err[1, 1] + pose_err[2, 2]
    return float(np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0)))


def _last_frame_from_segment(dist: np.ndarray, first: int, segment: float) -> int:
    later = np.nonzero(dist[first:] > dist[first] + segment)[0]
    return int(later[0]) + first if later.size else -1


def calc_sequence_errors(
    trajectory: np.ndarray,
    ground_truth: np.ndarray,
    segments=DEFAULT_SEGMENTS,
    step_size: int = 10,
) -> List[Dict]:
    """Per-(start, segment) errors, KITTI protocol (ref :318-358)."""
    dist = trajectory_distances(ground_truth)
    errors = []
    for first in range(0, ground_truth.shape[0], step_size):
        for seg in segments:
            last = _last_frame_from_segment(dist, first, seg)
            if last == -1:
                continue
            delta_gt = np.linalg.inv(ground_truth[first]) @ ground_truth[last]
            delta_tr = np.linalg.inv(trajectory[first]) @ trajectory[last]
            pose_err = np.linalg.inv(delta_tr) @ delta_gt
            num_frames = last - first + 1
            errors.append(
                {
                    "tr_err": float(np.linalg.norm(pose_err[:3, 3])) / seg,
                    "r_err": rotation_error(pose_err) / seg,
                    "segment": seg,
                    "speed": seg / (0.1 * num_frames),
                    "first_frame": first,
                    "last_frame": last,
                }
            )
    return errors


def compute_kitti_metrics(
    trajectory: np.ndarray, ground_truth: np.ndarray, segments=DEFAULT_SEGMENTS
) -> Tuple[Optional[float], Optional[float], List[Dict]]:
    """Average (t_rel, r_rel) over all segment windows (ref :361-380).

    ``t_rel`` is a fraction (×100 = the usual %), ``r_rel`` in rad/m.
    """
    errors = calc_sequence_errors(trajectory, ground_truth, segments)
    if not errors:
        return None, None, errors
    tr = float(np.mean([e["tr_err"] for e in errors]))
    rot = float(np.mean([e["r_err"] for e in errors]))
    return tr, rot, errors


def compute_ate(
    relative_predicted: np.ndarray, relative_ground_truth: np.ndarray
) -> Tuple[float, float]:
    """Mean/std of per-frame relative translation error (ref :383-391)."""
    err = np.linalg.norm(
        relative_predicted[:, :3, 3] - relative_ground_truth[:, :3, 3], axis=1
    )
    return float(err.mean()), float(err.std())


def compute_are(
    relative_predicted: np.ndarray, relative_ground_truth: np.ndarray
) -> Tuple[float, float]:
    """Mean/std of per-frame relative rotation error, Frobenius (ref :394-401)."""
    diff = (
        np.linalg.inv(relative_ground_truth[:, :3, :3])
        @ relative_predicted[:, :3, :3]
        - np.eye(3)
    )
    err = np.linalg.norm(diff, axis=(1, 2))
    return float(err.mean()), float(err.std())


def rescale_prediction(
    relative_predicted: np.ndarray, relative_ground_truth: np.ndarray
) -> np.ndarray:
    """Scale each relative translation so its norm matches the GT norm
    (ref ``eval_odometry.py:442-458``) — the scale-corrected evaluation used
    for monocular-style predictions with correct direction but wrong scale."""
    out = relative_predicted.copy()
    norm_pred = np.linalg.norm(relative_predicted[:, :3, 3], axis=1)
    norm_gt = np.linalg.norm(relative_ground_truth[:, :3, 3], axis=1)
    scale = np.where(norm_pred > 1e-6, norm_gt / np.maximum(norm_pred, 1e-12), 1.0)
    out[:, :3, 3] *= scale[:, None]
    return out


EVAL_MODES = ("normal", "rescale_simple", "eval_rotation", "eval_translation")


def apply_eval_mode(
    relative_predicted: np.ndarray,
    relative_ground_truth: np.ndarray,
    mode: str = "normal",
) -> np.ndarray:
    """Evaluation modes of the reference (``eval_odometry.py:518-523``):

    - ``normal``: poses evaluated as-is
    - ``rescale_simple``: per-frame translation-norm rescaling against GT
    - ``eval_rotation``: translations replaced by GT (isolates rotation error)
    - ``eval_translation``: rotations replaced by GT (isolates translation error)
    """
    if mode == "normal":
        return relative_predicted
    out = relative_predicted.copy()
    if mode == "rescale_simple":
        return rescale_prediction(out, relative_ground_truth)
    if mode == "eval_rotation":
        out[:, :3, 3] = relative_ground_truth[:, :3, 3]
        return out
    if mode == "eval_translation":
        out[:, :3, :3] = relative_ground_truth[:, :3, :3]
        return out
    raise ValueError(f"unknown eval mode {mode!r}; expected one of {EVAL_MODES}")


def metrics_dict(
    absolute_predicted: np.ndarray,
    absolute_ground_truth: np.ndarray,
    nsecs_per_frame: Optional[float] = None,
    segments=DEFAULT_SEGMENTS,
    mode: str = "normal",
) -> Dict[str, float]:
    """The ``metrics.yaml`` schema of the reference (``eval_odometry.py:703-719``):
    keys ``tr_err`` (%), ``rot_err`` (deg/100m), ``ATE``, ``STD_ATE``, ``ARE``,
    ``STD_ARE``, ``nsecs_per_frame``.

    ``mode`` selects the reference's evaluation modes (:518-523). Unlike the
    reference — which rescales only the relative poses it feeds to ATE/ARE and
    computes the KITTI segment metric on the untouched absolute trajectory —
    the mode here is applied to the relative poses and the absolute trajectory
    is recomposed from them, so every reported metric sees the same poses.
    """
    rel_pred = compute_relative_poses(absolute_predicted)
    rel_gt = compute_relative_poses(absolute_ground_truth)
    if mode != "normal":
        rel_pred = apply_eval_mode(rel_pred, rel_gt, mode)
        absolute_predicted = absolute_ground_truth[0] @ compute_absolute_poses(rel_pred)
    tr, rot, _ = compute_kitti_metrics(absolute_predicted, absolute_ground_truth, segments)
    ate, std_ate = compute_ate(rel_pred, rel_gt)
    are, std_are = compute_are(rel_pred, rel_gt)
    out = {
        "tr_err": 100.0 * tr if tr is not None else float("nan"),
        "rot_err": float(np.rad2deg(rot) * 100.0) if rot is not None else float("nan"),
        "ATE": ate,
        "STD_ATE": std_ate,
        "ARE": are,
        "STD_ARE": std_are,
    }
    if nsecs_per_frame is not None:
        out["nsecs_per_frame"] = float(nsecs_per_frame)
    return out
