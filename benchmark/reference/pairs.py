"""PWCLO-Net training pairs, built by the benchmark from its own drives: the
reference's batches, which the program's feed is held to.

The pair model the configuration states (the reference implementation's
KITTI pair loader over synthetic drives): a frame and the one before it
(a gap of up to ``max_frame_gap``), each scan filtered (ground below
−1.4 m and points beyond 30 m in x or y dropped) and sampled to
``num_points`` without replacement, the current scan moved by a random SE(3)
augmentation (clipped gaussian Euler angles and translation), and the
ground truth ``(t, q_wxyz)`` mapping current coordinates into previous ones,
the quaternion with ``w >= 0``. One numpy generator seeded by the feed's seed
draws, in order: each epoch's shuffle, then for each pair its gap, the
previous scan's sample, the current scan's sample and the augmentation.
Plain numpy; nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

GROUND_Z = -1.4
NEAR = 30.0


def filter_scan(pc: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    valid = np.linalg.norm(pc, axis=-1) > 1e-3
    keep = valid & (pc[:, 2] >= GROUND_Z) & (np.abs(pc[:, 0]) < NEAR) & (np.abs(pc[:, 1]) < NEAR)
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        idx = np.nonzero(valid)[0]
    if len(idx) >= n:
        sel = rng.choice(idx, n, replace=False)
    else:
        sel = np.concatenate([idx, rng.choice(idx, n - len(idx), replace=True)])
    return pc[sel].astype(np.float32)


def augmentation(rng: np.random.Generator) -> np.ndarray:
    """A random SE(3) ``(4, 4)``: R = Rx Ry Rz of clipped gaussian angles
    (yaw-like y dominant), a clipped gaussian translation (z dominant)."""
    ax = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    ay = np.clip(0.05 * rng.standard_normal(), -0.1, 0.1) * np.pi / 4.0
    az = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    t = np.array([np.clip(0.1 * rng.standard_normal(), -0.2, 0.2),
                  np.clip(0.05 * rng.standard_normal(), -0.15, 0.15),
                  np.clip(0.5 * rng.standard_normal(), -1.0, 1.0)])
    out = np.eye(4)
    out[:3, :3] = rx @ ry @ rz
    out[:3, 3] = t
    return out


def quaternion(r: np.ndarray) -> np.ndarray:
    """``(3, 3)`` rotation → unit ``(w, x, y, z)`` with ``w >= 0`` (Shepperd:
    the candidate of the largest diagonal combination, normalised)."""
    m = r
    cands = np.array([
        [1 + m[0, 0] + m[1, 1] + m[2, 2], m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], 1 + m[0, 0] - m[1, 1] - m[2, 2], m[1, 0] + m[0, 1], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[1, 0] + m[0, 1], 1 - m[0, 0] + m[1, 1] - m[2, 2], m[2, 1] + m[1, 2]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[2, 1] + m[1, 2], 1 - m[0, 0] - m[1, 1] + m[2, 2]],
    ])
    q = cands[int(np.argmax(np.diag(cands)))]
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def pose_params(pose: np.ndarray) -> np.ndarray:
    return np.concatenate([pose[:3, 3], quaternion(pose[:3, :3])]).astype(np.float32)


class Pairs:
    """The pairs of ``drives`` (each ``(scans, poses)``) in the feed's order."""

    def __init__(self, drives: Sequence[Tuple[List[np.ndarray], np.ndarray]], num_points: int,
                 max_frame_gap: int, augment: bool, seed: int):
        self.drives, self.n, self.gap, self.augment = drives, num_points, max_frame_gap, augment
        self.rng = np.random.default_rng(seed)
        self.index = [(s, i) for s, (scans, _) in enumerate(drives) for i in range(1, len(scans))]

    def item(self, k: int) -> Dict[str, np.ndarray]:
        s, i2 = self.index[k]
        scans, poses = self.drives[s]
        i1 = max(i2 - int(self.rng.integers(1, self.gap + 1)), 0)
        prev = filter_scan(scans[i1], self.n, self.rng)
        cur = filter_scan(scans[i2], self.n, self.rng)
        rel = np.linalg.inv(poses[i1]) @ poses[i2]
        if self.augment:
            aug = augmentation(self.rng)
            hom = np.concatenate([cur, np.ones((self.n, 1))], -1)
            cur = (aug @ hom.T).T[:, :3].astype(np.float32)
            rel = rel @ np.linalg.inv(aug)
        return {"xyz1": cur, "xyz2": prev, "gt_params": pose_params(rel)}

    def batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Endless: epoch after epoch, each shuffled, its last partial batch
        dropped."""
        while True:
            order = np.arange(len(self.index))
            self.rng.shuffle(order)
            for lo in range(0, len(order) - batch + 1, batch):
                items = [self.item(int(k)) for k in order[lo: lo + batch]]
                yield {key: np.stack([it[key] for it in items]) for key in items[0]}
