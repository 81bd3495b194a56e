"""Evaluation: KITTI odometry metrics (numpy), results persistence and
plots, and the headless visualization (``viz.py``, ``gallery.py``,
``player.py``)."""

from pwclonet_pylidarslam_torch.evaluation.metrics import (  # noqa: F401
    compute_absolute_poses,
    compute_are,
    compute_ate,
    compute_kitti_metrics,
    compute_relative_poses,
)
