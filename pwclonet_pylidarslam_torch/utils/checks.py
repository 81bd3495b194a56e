"""Shape and NaN contract checks.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/utils/checks.py``, with the
same messages: shape checks with ``-1`` wildcards, a debug assertion, the
host-side removal of non-finite rows and the device-side scrub.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def check_tensor(x, shape: Sequence[int], name: str = "tensor"):
    """Assert the shape of ``x`` (a tensor or an array); ``-1`` matches any
    size. Returns ``x``."""
    actual = tuple(x.shape)
    if len(actual) != len(shape):
        raise AssertionError(f"{name}: rank {len(actual)} != expected {len(shape)}")
    for i, (a, e) in enumerate(zip(actual, shape)):
        if e != -1 and a != e:
            raise AssertionError(f"{name}: dim {i} is {a}, expected {e} ({actual} vs {shape})")
    return x


def assert_debug(condition: bool, message: str = ""):
    if not condition:
        raise AssertionError(message or "assert_debug failed")


def remove_nan(points: np.ndarray) -> np.ndarray:
    """Drop the rows of ``points`` that hold a non-finite value (host side)."""
    return points[np.isfinite(points).all(axis=-1)]


def scrub_nonfinite(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Non-finite values of ``x`` replaced by ``fill``; the shape is kept."""
    return torch.where(torch.isfinite(x), x, fill)
