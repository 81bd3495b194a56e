"""Vertex-map pair and window batches for PoseResNet training.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/data/vm_pairs.py``:
consecutive-frame vertex-map pairs (or windows of ``sequence_len`` frames)
with the relative ground-truth poses, built from any scan source. The scans
are projected on the device in chunks of one shape (the tail padded), then
served from a host-side cache: a 64×720×3 vertex map is ~0.5 MB, so whole
KITTI sequences fit in host memory. Shuffling is by ``seed``, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core.projection import SphericalProjector
from pwclonet_pylidarslam_torch.device import resolve_device


def project_scans(
    scans: Sequence[np.ndarray],
    projector: SphericalProjector,
    num_points: int = 65536,
    chunk: int = 8,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Project variable-size scans into ``(T, H, W, 3)`` vertex maps on
    ``device`` (CUDA unless the caller asks for the CPU).

    Each scan is cut to ``num_points`` points by an even stride, or
    zero-padded (the z-buffer ignores zero points).
    """
    dev = resolve_device(device)
    fixed = np.zeros((len(scans), num_points, 3), np.float32)
    for i, s in enumerate(scans):
        s = np.asarray(s, np.float32)[:, :3]
        s = s[np.linalg.norm(s, axis=-1) > 1e-6]
        if len(s) > num_points:  # a deterministic stride keeps the angular coverage
            fixed[i] = s[np.linspace(0, len(s) - 1, num_points).astype(np.int64)]
        else:
            fixed[i, :len(s)] = s
    out: List[np.ndarray] = []
    for start in range(0, len(scans), chunk):
        block = fixed[start:start + chunk]
        n = len(block)
        if n < chunk:  # the tail padded to the chunk's shape
            block = np.concatenate([block, np.zeros((chunk - n, num_points, 3), np.float32)])
        vm = projector.build_projection_map(torch.from_numpy(block).to(dev))
        out.append(vm[:n].cpu().numpy())
    if not out:
        return np.zeros((0, projector.height, projector.width, 3), np.float32)
    return np.concatenate(out)


def _batches(dataset, batch_size: int, shuffle: bool, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Full batches of ``dataset``'s items, in an order shuffled by ``seed``."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order) - batch_size + 1, batch_size):
        items = [dataset[int(j)] for j in order[start:start + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


@dataclasses.dataclass
class VertexMapPairDataset:
    """Consecutive-frame ``(vm1=current, vm2=previous, gt_pose)`` pairs;
    ``gt_pose = inv(abs[i-1]) @ abs[i]`` maps current-frame coordinates into
    previous-frame ones."""

    vertex_maps: np.ndarray  # (T, H, W, 3)
    gt_absolute: Optional[np.ndarray] = None  # (T, 4, 4)

    @classmethod
    def from_scans(cls, scans: Sequence[np.ndarray], gt_absolute: Optional[np.ndarray],
                   projector: SphericalProjector = SphericalProjector(),
                   num_points: int = 65536,
                   device: Union[str, torch.device] = "cuda") -> "VertexMapPairDataset":
        return cls(project_scans(scans, projector, num_points, device=device), gt_absolute)

    def __len__(self) -> int:
        return max(len(self.vertex_maps) - 1, 0)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        item = {"vm1": self.vertex_maps[i + 1], "vm2": self.vertex_maps[i]}
        if self.gt_absolute is not None:
            rel = np.linalg.inv(self.gt_absolute[i]) @ self.gt_absolute[i + 1]
            item["gt_pose"] = rel.astype(np.float32)
        return item

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self, batch_size, shuffle, seed)


@dataclasses.dataclass
class VertexMapWindowDataset:
    """Sliding windows of ``sequence_len`` frames, ``stride`` apart: ``T −
    S·stride + 1`` windows. Items are newest first: ``frames[k] =
    vm[start + (S-1-k)·stride]``, and ``gt_poses[k]`` maps ``frames[k]``
    coordinates into ``frames[k+1]`` coordinates."""

    vertex_maps: np.ndarray  # (T, H, W, 3)
    gt_absolute: Optional[np.ndarray] = None  # (T, 4, 4)
    sequence_len: int = 3
    stride: int = 1

    @classmethod
    def from_scans(cls, scans: Sequence[np.ndarray], gt_absolute: Optional[np.ndarray],
                   projector: SphericalProjector = SphericalProjector(),
                   num_points: int = 65536, sequence_len: int = 3, stride: int = 1,
                   device: Union[str, torch.device] = "cuda") -> "VertexMapWindowDataset":
        vms = project_scans(scans, projector, num_points, device=device)
        gt = None if gt_absolute is None else np.asarray(gt_absolute, np.float64)
        return cls(vms, gt, sequence_len, stride)

    def __len__(self) -> int:
        return max(len(self.vertex_maps) - self.sequence_len * self.stride + 1, 0)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.sequence_len
        idx = [i + k * self.stride for k in range(s)]  # oldest → newest
        item = {"frames": np.stack([self.vertex_maps[j] for j in reversed(idx)])}
        if self.gt_absolute is not None:
            rels = [np.linalg.inv(self.gt_absolute[idx[s - 2 - k]]) @ self.gt_absolute[idx[s - 1 - k]]
                    for k in range(s - 1)]
            item["gt_poses"] = np.stack(rels).astype(np.float32)
        return item

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self, batch_size, shuffle, seed)


@dataclasses.dataclass
class MultiSequenceWindowDataset:
    """Items pooled across sequences, never spanning a boundary."""

    datasets: List

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        for d in self.datasets:
            if i < len(d):
                return d[i]
            i -= len(d)
        raise IndexError(i)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self, batch_size, shuffle, seed)


class MultiSequencePairDataset(MultiSequenceWindowDataset):
    """Pairs pooled across sequences, never pairing across a boundary."""


def concat_pair_datasets(datasets: Sequence[VertexMapPairDataset]) -> MultiSequencePairDataset:
    return MultiSequencePairDataset(list(datasets))
