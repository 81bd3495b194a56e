"""Load a Flax variable tree into the port's modules.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as the reference's
``model.init``/trainer produce it, given as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``), so this module never sees JAX.

The port's submodules carry the Flax auto-names, so a leaf at Flax path
``params/SetConv_0/PointMLP_0/kernel_0`` is the torch entry
``SetConv_0.PointMLP_0.kernel_0``; batch statistics (``mean_i``/``var_i``)
are buffers. Flax ``Dense`` kernels are ``(Cin, Cout)`` and become the
transposed ``nn.Linear`` weight; ``PointMLP`` kernels keep ``(Cin, Cout)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested dicts → ``{"params/SetConv_0/PointMLP_0/kernel_0": array}``,
    in the tree's own order."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), child)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def _torch_key(flax_path: str) -> tuple:
    """Flax path → (torch state-dict key, transpose?)."""
    collection, *rest = flax_path.split("/")
    if collection not in ("params", "batch_stats"):
        raise KeyError(f"unexpected variable collection {collection!r} in {flax_path!r}")
    if len(rest) >= 2 and rest[-2] == "Dense_0" and rest[-1] == "kernel":
        return ".".join(rest[:-1] + ["weight"]), True
    return ".".join(rest), False


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy every leaf of ``variables`` into ``model`` (in place) and return it.

    Raises if a leaf has no torch counterpart, if a torch parameter or
    buffer is left unset, or if any shape differs.
    """
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    unset = set(targets)
    for path, value in flatten_variables(variables).items():
        key, transpose = _torch_key(path)
        if key not in targets:
            raise KeyError(f"Flax leaf {path!r} has no torch counterpart {key!r}")
        value = value.T if transpose else value
        dst = targets[key]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(
                f"shape mismatch for {path!r}: Flax {tuple(value.shape)} vs torch {tuple(dst.shape)}"
            )
        dst.copy_(torch.tensor(value, dtype=dst.dtype))
        unset.remove(key)
    if unset:
        raise KeyError(f"torch entries left unset by the Flax tree: {sorted(unset)}")
    return model
