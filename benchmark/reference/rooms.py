"""Procedural indoor blocks: a frozen copy of the room generator the
benchmark feeds PointNet++ segmentation with.

As the port's ``data/shapes.py::SyntheticRooms`` had it when this benchmark
was written: a floor (class 0), two walls (1, 2) and a clutter sphere (3) in
a unit block, 9 channels a point like an Indoor3D (S3DIS) block (xyz, a
colour left at 0, xyz about the block's mean). Plain numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sphere(n: int, rng: np.random.Generator) -> np.ndarray:
    u, v = rng.random(n), rng.random(n)
    theta, phi = 2 * np.pi * u, np.arccos(2 * v - 1)
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
                    -1).astype(np.float32)


def room_block(seed: int, idx: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Block ``idx`` of the set drawn from ``seed``: ``(points (n, 9) float32,
    labels (n,) int64)``."""
    rng = np.random.default_rng((seed, idx, 7))
    quota = [n // 2, n // 6, n // 6, n - n // 2 - 2 * (n // 6)]
    floor = np.stack([rng.random(quota[0]), rng.random(quota[0]), np.zeros(quota[0])], -1)
    w1 = np.stack([rng.random(quota[1]), np.zeros(quota[1]), rng.random(quota[1])], -1)
    w2 = np.stack([np.zeros(quota[2]), rng.random(quota[2]), rng.random(quota[2])], -1)
    clutter = _sphere(quota[3], rng) * 0.08 + rng.uniform(0.2, 0.8, 3)
    pts = np.concatenate([floor, w1, w2, clutter]).astype(np.float32)
    labels = np.concatenate([np.full(q, c) for c, q in enumerate(quota)]).astype(np.int64)
    pts += 0.005 * rng.normal(size=pts.shape).astype(np.float32)
    perm = rng.permutation(n)
    pts, labels = pts[perm], labels[perm]
    feats = np.concatenate([pts, np.zeros_like(pts), pts - pts.mean(0, keepdims=True)], axis=1)
    return feats.astype(np.float32), labels


def room_blocks(seed: int, count: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` blocks: ``(points (count, n, 9), labels (count, n))``."""
    blocks = [room_block(seed, i, n) for i in range(count)]
    return np.stack([b[0] for b in blocks]), np.stack([b[1] for b in blocks])
