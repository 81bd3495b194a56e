"""Shape-classification / indoor-segmentation datasets and augmentations.

The port's own copy of ``pwclonet_pylidarslam_tpu/data/shapes.py`` (numpy
only; the port imports nothing of the JAX package): the data layer of the
PointNet++ cls/semseg family. Readers emit fixed-shape ``(B, N, C)`` numpy
batches, one upload each.

- :class:`ModelNet40Dataset` reads the ``modelnet40_normal_resampled`` tree
  (per-shape CSV of x,y,z,nx,ny,nz + split files).
- :class:`Indoor3DSemSegDataset` reads the ``indoor3d_sem_seg_hdf5_data``
  HDF5 bundle with the Area_5 train/test split (``h5py`` is imported when
  one is opened).
- The augmentations are pure functions of an explicit
  ``numpy.random.Generator``; under one generator they draw what the
  reference's draw, in the same order.
- :class:`SyntheticShapes` / :class:`SyntheticRooms` are procedural sets, so
  that training and tests run with no downloaded data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pwclonet_pylidarslam_torch.utils.timer import span


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center on the centroid, scale into the unit sphere
    (ref ``ModelNet40Loader.py:17-23``)."""
    pc = pc - pc.mean(axis=0, keepdims=True)
    m = np.sqrt((pc**2).sum(axis=1)).max()
    return pc / max(m, 1e-12)


# ---------------------------------------------------------------------------
# Augmentations (ref data_utils.py — same defaults, explicit rng)
# ---------------------------------------------------------------------------


def angle_axis(angle: float, axis: np.ndarray) -> np.ndarray:
    """Rotation matrix from angle/axis via Rodrigues (ref ``data_utils.py:5-35``)."""
    u = np.asarray(axis, dtype=np.float64)
    u = u / np.linalg.norm(u)
    cos, sin = np.cos(angle), np.sin(angle)
    cross = np.array(
        [[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]]
    )
    R = cos * np.eye(3) + sin * cross + (1.0 - cos) * np.outer(u, u)
    return R.astype(np.float32)


def scale_points(points, rng, lo: float = 0.8, hi: float = 1.25):
    """Uniform global scale on xyz (ref ``PointcloudScale``)."""
    out = points.copy()
    out[:, :3] *= rng.uniform(lo, hi)
    return out


def rotate_points(points, angle: float, axis=(0.0, 1.0, 0.0)):
    """Rotate xyz (and normals in columns 3:6 if present) about ``axis``
    (ref ``PointcloudRotate``)."""
    R = angle_axis(angle, np.asarray(axis))
    out = points.copy()
    out[:, :3] = points[:, :3] @ R.T
    if points.shape[1] >= 6:
        out[:, 3:6] = points[:, 3:6] @ R.T
    return out


def rotate_points_random(points, rng, axis=(0.0, 1.0, 0.0)):
    return rotate_points(points, rng.uniform(0.0, 2.0 * np.pi), axis)


def rotate_perturbation(points, rng, angle_sigma: float = 0.06, angle_clip: float = 0.18):
    """Small random rotation about all three axes (ref ``PointcloudRotatePerturbation``)."""
    angles = np.clip(angle_sigma * rng.normal(size=3), -angle_clip, angle_clip)
    R = (
        angle_axis(angles[2], np.array([0.0, 0.0, 1.0]))
        @ angle_axis(angles[1], np.array([0.0, 1.0, 0.0]))
        @ angle_axis(angles[0], np.array([1.0, 0.0, 0.0]))
    )
    out = points.copy()
    out[:, :3] = points[:, :3] @ R.T
    if points.shape[1] >= 6:
        out[:, 3:6] = points[:, 3:6] @ R.T
    return out


def jitter_points(points, rng, std: float = 0.01, clip: float = 0.05):
    """Per-point clipped Gaussian jitter on xyz (ref ``PointcloudJitter``)."""
    out = points.copy()
    out[:, :3] += np.clip(
        std * rng.normal(size=(points.shape[0], 3)), -clip, clip
    ).astype(points.dtype)
    return out


def translate_points(points, rng, translate_range: float = 0.1):
    """Global random translation (ref ``PointcloudTranslate``)."""
    out = points.copy()
    out[:, :3] += rng.uniform(-translate_range, translate_range, size=3).astype(
        points.dtype
    )
    return out


def random_input_dropout(points, rng, max_dropout_ratio: float = 0.875):
    """Replace a random subset by the first point — keeps the shape static
    (ref ``PointcloudRandomInputDropout``; the first-point fill is theirs too)."""
    out = points.copy()
    dropout_ratio = rng.random() * max_dropout_ratio
    drop = np.nonzero(rng.random(points.shape[0]) <= dropout_ratio)[0]
    if drop.size:
        out[drop] = out[0]
    return out


def augment_cls(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The upstream classification train-time augmentation stack
    (``train.py`` transforms: scale → rotate(y) → rotate-perturb → jitter →
    translate → dropout)."""
    points = scale_points(points, rng)
    points = rotate_points_random(points, rng)
    points = rotate_perturbation(points, rng)
    points = jitter_points(points, rng)
    points = translate_points(points, rng)
    return random_input_dropout(points, rng)


# ---------------------------------------------------------------------------
# ModelNet40 (modelnet40_normal_resampled tree)
# ---------------------------------------------------------------------------


class ModelNet40Dataset:
    """ModelNet40 classification set.

    Directory layout (the zip the reference downloads,
    ``ModelNet40Loader.py:36-52``)::

        root/modelnet40_shape_names.txt      one class name per line
        root/modelnet40_{train,test}.txt     shape ids, e.g. ``airplane_0001``
        root/<class>/<shape_id>.txt          CSV rows x,y,z,nx,ny,nz

    Shapes load lazily and cache in memory (the reference builds an LMDB
    cache for the same purpose). ``__getitem__`` → ``(points (num_points, C),
    label int)``; xyz is unit-sphere normalized, train items are randomly
    subsampled, test items take the first ``num_points`` (upstream protocol).
    """

    def __init__(
        self,
        root: str,
        num_points: int = 1024,
        train: bool = True,
        use_normals: bool = False,
        seed: int = 0,
        cache: bool = True,
    ):
        self.root = root
        self.num_points = num_points
        self.train = train
        self.use_normals = use_normals
        self._rng = np.random.default_rng(seed)
        catfile = os.path.join(root, "modelnet40_shape_names.txt")
        with open(catfile) as f:
            self.classes: List[str] = [ln.strip() for ln in f if ln.strip()]
        self._class_to_idx = {c: i for i, c in enumerate(self.classes)}
        split = "train" if train else "test"
        with open(os.path.join(root, f"modelnet40_{split}.txt")) as f:
            shape_ids = [ln.strip() for ln in f if ln.strip()]
        self.items: List[Tuple[str, int]] = []
        for sid in shape_ids:
            name = "_".join(sid.split("_")[:-1])
            self.items.append(
                (os.path.join(root, name, sid + ".txt"), self._class_to_idx[name])
            )
        self._cache: Optional[Dict[int, np.ndarray]] = {} if cache else None

    def __len__(self) -> int:
        return len(self.items)

    def _load(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        path, _ = self.items[idx]
        pts = np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(-1, 6)
        if self._cache is not None:
            self._cache[idx] = pts
        return pts

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        pts = self._load(idx)
        if self.train:
            sel = self._rng.choice(len(pts), self.num_points, replace=len(pts) < self.num_points)
            pts = pts[sel]
        else:
            pts = pts[: self.num_points]
            if len(pts) < self.num_points:  # pad by repetition, fixed shapes
                reps = -(-self.num_points // len(pts))
                pts = np.tile(pts, (reps, 1))[: self.num_points]
        pts = pts.copy()
        pts[:, :3] = pc_normalize(pts[:, :3])
        if not self.use_normals:
            pts = pts[:, :3]
        label = self.items[idx][1]
        return pts.astype(np.float32), label


# ---------------------------------------------------------------------------
# Indoor3D semantic segmentation (S3DIS hdf5 bundle)
# ---------------------------------------------------------------------------


class Indoor3DSemSegDataset:
    """Stanford Indoor3D semantic segmentation, hdf5 bundle format
    (ref ``Indoor3DSemSegLoader.py:25-91``): ``all_files.txt`` lists h5 files
    with ``data (M, 4096, 9)`` and ``label (M, 4096)``; ``room_filelist.txt``
    maps blocks to rooms; blocks from ``Area_5`` form the test split.

    ``__getitem__`` → ``(points (num_points, 9), labels (num_points,))`` with
    a fresh random permutation of the block's points each access (upstream
    shuffles ``pt_idxs`` per item).
    """

    NUM_CLASSES = 13

    def __init__(
        self,
        root: str,
        num_points: int = 4096,
        train: bool = True,
        test_area: str = "Area_5",
        data_percent: float = 1.0,
        seed: int = 0,
    ):
        import h5py

        self._rng = np.random.default_rng(seed)
        self.num_points = num_points
        with open(os.path.join(root, "all_files.txt")) as f:
            all_files = [ln.strip() for ln in f if ln.strip()]
        with open(os.path.join(root, "room_filelist.txt")) as f:
            rooms = [ln.strip() for ln in f if ln.strip()]
        datas, labels = [], []
        for fn in all_files:
            path = os.path.join(root, os.path.basename(fn))
            with h5py.File(path, "r") as f:
                datas.append(np.asarray(f["data"], dtype=np.float32))
                labels.append(np.asarray(f["label"], dtype=np.int32))
        data = np.concatenate(datas, axis=0)
        label = np.concatenate(labels, axis=0)
        is_test = np.array([test_area in r for r in rooms], dtype=bool)
        keep = ~is_test if train else is_test
        self.points = data[keep]
        self.labels = label[keep]
        self._len = int(len(self.points) * data_percent)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        sel = self._rng.permutation(self.points.shape[1])[: self.num_points]
        return self.points[idx, sel], self.labels[idx, sel].astype(np.int32)


# ---------------------------------------------------------------------------
# Synthetic procedural fixtures (no data needed)
# ---------------------------------------------------------------------------

SHAPE_CLASSES = ("sphere", "cube", "cylinder", "cone", "torus", "plane")


def _sample_shape(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    u = rng.random(n)
    v = rng.random(n)
    if kind == "sphere":
        theta, phi = 2 * np.pi * u, np.arccos(2 * v - 1)
        pts = np.stack(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
        )
    elif kind == "cube":
        pts = rng.uniform(-1, 1, size=(n, 3))
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), face] = sign
    elif kind == "cylinder":
        theta = 2 * np.pi * u
        pts = np.stack([np.cos(theta), np.sin(theta), 2 * v - 1], -1)
    elif kind == "cone":
        theta = 2 * np.pi * u
        r = np.sqrt(v)
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), 1 - 2 * r], -1)
    elif kind == "torus":
        theta, phi = 2 * np.pi * u, 2 * np.pi * v
        R, r = 1.0, 0.35
        pts = np.stack(
            [
                (R + r * np.cos(phi)) * np.cos(theta),
                (R + r * np.cos(phi)) * np.sin(theta),
                r * np.sin(phi),
            ],
            -1,
        )
    elif kind == "plane":
        pts = np.stack([2 * u - 1, 2 * v - 1, np.zeros(n)], -1)
    else:
        raise ValueError(f"unknown shape {kind!r}")
    return pts.astype(np.float32)


@dataclass
class SyntheticShapes:
    """Procedural classification set over :data:`SHAPE_CLASSES`."""

    num_items: int = 240
    num_points: int = 1024
    seed: int = 0
    noise: float = 0.01

    def __post_init__(self):
        self.classes = list(SHAPE_CLASSES)

    def __len__(self):
        return self.num_items

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng((self.seed, idx))
        label = idx % len(self.classes)
        pts = _sample_shape(self.classes[label], self.num_points, rng)
        pts += self.noise * rng.normal(size=pts.shape).astype(np.float32)
        return pc_normalize(pts).astype(np.float32), label


@dataclass
class SyntheticRooms:
    """Procedural semseg blocks: floor plane (class 0), two walls (1, 2) and
    clutter spheres (3). Points are (x,y,z,r,g,b,nx,ny,nz)-shaped like the
    Indoor3D blocks (9 channels) so the model contract matches."""

    num_items: int = 64
    num_points: int = 2048
    seed: int = 0
    num_classes: int = 4

    def __len__(self):
        return self.num_items

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx, 7))
        n = self.num_points
        quota = [n // 2, n // 6, n // 6, n - n // 2 - 2 * (n // 6)]
        xyz, lbl = [], []
        floor = np.stack([rng.random(quota[0]), rng.random(quota[0]), np.zeros(quota[0])], -1)
        xyz.append(floor); lbl.append(np.zeros(quota[0]))
        w1 = np.stack([rng.random(quota[1]), np.zeros(quota[1]), rng.random(quota[1])], -1)
        xyz.append(w1); lbl.append(np.full(quota[1], 1))
        w2 = np.stack([np.zeros(quota[2]), rng.random(quota[2]), rng.random(quota[2])], -1)
        xyz.append(w2); lbl.append(np.full(quota[2], 2))
        c = _sample_shape("sphere", quota[3], rng) * 0.08 + rng.uniform(0.2, 0.8, 3)
        xyz.append(c); lbl.append(np.full(quota[3], 3))
        pts = np.concatenate(xyz).astype(np.float32)
        pts += 0.005 * rng.normal(size=pts.shape).astype(np.float32)
        labels = np.concatenate(lbl).astype(np.int32)
        perm = rng.permutation(n)
        pts, labels = pts[perm], labels[perm]
        feats = np.concatenate(
            [pts, np.zeros_like(pts), pts - pts.mean(0, keepdims=True)], axis=1
        )
        return feats.astype(np.float32), labels


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


def batches(
    dataset,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    augment: bool = False,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape ``{"points", "labels"}`` batches (one device upload each).

    ``augment=True`` applies :func:`augment_cls` per item (classification
    datasets only — items whose second element is a scalar label)."""
    order = np.arange(len(dataset))
    if shuffle:
        rng = rng or np.random.default_rng(0)
        order = rng.permutation(order)
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    for start in range(0, end, batch_size):
        idxs = order[start : start + batch_size]
        pts_list, lbl_list = [], []
        with span("data.collate"):
            for i in idxs:
                pts, lbl = dataset[int(i)]
                if augment and np.ndim(lbl) == 0:
                    pts = augment_cls(pts, rng or np.random.default_rng(int(i)))
                pts_list.append(pts)
                lbl_list.append(lbl)
            batch = {
                "points": np.stack(pts_list).astype(np.float32),
                "labels": np.asarray(lbl_list),
            }
        yield batch
