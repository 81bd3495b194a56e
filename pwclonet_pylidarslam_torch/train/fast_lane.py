"""The fast-lane learning recipe: train a small PWCLO-Net on synthetic-world
frame pairs and score it on held-out worlds.

Counterpart of ``run_fast_lane_recipe`` in the reference's
``tests/test_deep_odometry_accuracy.py``: two ``along_path`` train worlds of
26 frames, ``epochs`` epochs of ``len(dataset) // 8`` steps at batch 8, a
warmup-cosine learning rate matched to the step count, two held-out worlds.
A net that has learned pose lands its relative-pose RMSE well under the
per-frame travel; an untrained one sits at about the travel. The dropout
masks are this port's own, so a run is another draw of the recipe than the
reference's, not a replay of it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.data.synthetic import (
    SyntheticPairDataset,
    SyntheticSequenceConfig,
    filter_scan_sensor_frame,
    generate_sequence,
)
from pwclonet_pylidarslam_torch.evaluation import metrics
from pwclonet_pylidarslam_torch.models import PWCLONetConfig, load_flax_train_state
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry
from pwclonet_pylidarslam_torch.train.state import TrainConfig, create_train_state, train_steps

N_POINTS = 256
SMALL = PWCLONetConfig(num_points=N_POINTS, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))


def _world(seed: int, device, frames: int = 26):
    return generate_sequence(SyntheticSequenceConfig(
        n_frames=frames, trajectory="curve", world="along_path",
        num_beams=16, num_cols=256, num_points=2048, seed=seed), device=device)


def _odometry_ate(variables: Mapping, scans: np.ndarray, gt: np.ndarray, device):
    odo = PWCLONetOdometry(variables, DeepOdometryConfig(model=SMALL, num_points=N_POINTS),
                           device=device)
    odo.init()
    rng = np.random.default_rng(0)
    filtered = np.stack([filter_scan_sensor_frame(s, N_POINTS, rng) for s in scans])
    odo.process_sequence(filtered)
    pred = odo.absolute_poses()
    ate, _ = metrics.compute_ate(metrics.compute_relative_poses(pred),
                                 metrics.compute_relative_poses(gt))
    return ate, pred


def run_fast_lane_recipe(
    device: Union[str, torch.device] = "cuda", epochs: int = 40, lr: float = 4e-3,
    warmup_frac: float = 0.05, seed: int = 0, init_tree: Optional[Mapping] = None,
) -> Dict:
    """Train and score; returns ``{"losses" (per epoch), "ates" (per held-out
    world), "travel", "ratio" (mean ATE over mean per-frame travel),
    "untrained_ate", "finite", "steps"}``. ``init_tree``: a reference train
    state (``models/convert.py``) to start from in place of the seeded init."""
    train_seqs = [_world(s, device) for s in (1, 2)]
    ds = SyntheticPairDataset(train_seqs, num_points=N_POINTS, augment=False, seed=0)
    total = epochs * (len(ds) // 8)
    cfg = TrainConfig(model=SMALL, total_steps=total, learning_rate=lr,
                      warmup_steps=int(total * warmup_frac))
    state = create_train_state(cfg, seed=seed, device=device)
    if init_tree is not None:
        load_flax_train_state(state, init_tree)
    untrained = state.state_dict()

    losses = []
    for epoch in range(epochs):
        batches = list(ds.batches(8, shuffle=True, seed=epoch))
        block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        logs = train_steps(cfg, state, block)
        losses.append(float(logs["loss"].mean()))

    heldout = [_world(s, state.device) for s in (9, 10)]
    trained = state.state_dict()
    ates, travels, finite = [], [], True
    for scans, gt in heldout:
        ate, pred = _odometry_ate(trained, scans, gt, state.device)
        finite = finite and bool(np.isfinite(pred).all())
        ates.append(ate)
        travels.append(float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).mean()))
    ate0, _ = _odometry_ate(untrained, *heldout[0], state.device)
    return {
        "losses": losses,
        "ates": ates,
        "travel": float(np.mean(travels)),
        "ratio": float(np.mean(ates)) / float(np.mean(travels)),
        "untrained_ate": ate0,
        "finite": finite,
        "steps": state.step,
    }
