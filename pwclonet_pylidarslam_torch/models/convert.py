"""Load a Flax variable tree, or a whole reference train state, into the port.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as the reference's
``model.init``/trainer produce it, given as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``), so this module never sees JAX.

The port's submodules carry the Flax auto-names, so a leaf at Flax path
``params/SetConv_0/PointMLP_0/kernel_0`` is the torch entry
``SetConv_0.PointMLP_0.kernel_0``; batch statistics (``mean_i``/``var_i``)
are buffers. Flax ``Dense`` kernels are ``(Cin, Cout)`` and become the
transposed ``nn.Linear`` weight; ``PointMLP`` kernels keep ``(Cin, Cout)``.
PoseResNet's ``Conv_i`` kernels (HWIO) become ``nn.Conv2d`` weights (OIHW)
and its ``BatchNorm_i`` leaves take the torch names (``weight``, ``bias``,
``running_mean``, ``running_var``).

A reference train state crosses as the nested dict (or the ``.npz`` of its
flattened paths, written by ``tools/export_flax_checkpoint.py``)
``{"params", "batch_stats", "loss_params": {"s_param"} (or empty), "opt_state":
{"count", "mu": {"net", "loss"}, "nu": {"net", "loss"}}, "step"}``:
:func:`load_flax_train_state` puts Adam's ``mu``/``nu``/``count`` into the
``exp_avg``/``exp_avg_sq``/``count`` of the matching parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


_BATCHNORM_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                    "var": "running_var"}


def _torch_key(flax_path: str) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """Flax path → (torch state-dict key, permutation of the value's axes or
    None). ``Dense_0``/``Dense_1`` kernels ``(Cin, Cout)`` are transposed
    into ``nn.Linear`` weights, ``Conv_i`` kernels HWIO become OIHW, and a
    ``BatchNorm_i``'s ``scale``/``bias``/``mean``/``var`` are the port's
    ``weight``/``bias``/``running_mean``/``running_var``."""
    collection, *rest = flax_path.split("/")
    if collection not in ("params", "batch_stats"):
        raise KeyError(f"unexpected variable collection {collection!r} in {flax_path!r}")
    parent, leaf = (rest[-2], rest[-1]) if len(rest) >= 2 else ("", rest[-1])
    if parent in ("Dense_0", "Dense_1") and leaf == "kernel":
        return ".".join(rest[:-1] + ["weight"]), (1, 0)
    if parent.startswith("Conv_") and leaf == "kernel":
        return ".".join(rest[:-1] + ["weight"]), (3, 2, 0, 1)
    if parent.startswith("BatchNorm_") and leaf in _BATCHNORM_NAMES:
        return ".".join(rest[:-1] + [_BATCHNORM_NAMES[leaf]]), None
    return ".".join(rest), None


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
        key, perm = _torch_key(path)
        if key not in targets:
            raise KeyError(f"Flax leaf {path!r} has no torch counterpart {key!r}")
        value = value if perm is None else value.transpose(perm)
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


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> Dict:
    """The inverse of :func:`flatten_variables`."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def load_flax_npz(path) -> Dict:
    """The nested tree of an ``.npz`` whose keys are flattened paths."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten_variables({key: data[key] for key in data.files})


def _trainable_key(path: str) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """Path under an optimizer moment (``net/...`` or ``loss/...``) →
    (key of ``TrainState.trainable()``, permutation of the axes or None)."""
    group, rest = path.split("/", 1)
    if group == "loss":
        return f"loss.{rest.replace('/', '.')}", None
    if group != "net":
        raise KeyError(f"unexpected group {group!r} in optimizer moment path {path!r}")
    key, perm = _torch_key(f"params/{rest}")
    return f"net.{key}", perm


@torch.no_grad()
def load_flax_train_state(state, tree: Mapping):
    """Copy a whole reference train state (see the module docstring) into
    the port's ``TrainState`` ``state``, in place, and return it: network
    parameters and running statistics, loss parameters, Adam's moments and
    update count, and the step. Raises if a leaf has no counterpart, if
    anything of the port's state is left unset, or if a shape differs."""
    load_flax_variables(state.model, {"params": tree["params"],
                                      "batch_stats": tree["batch_stats"]})
    given = flatten_variables(tree.get("loss_params", {}))
    if set(given) != set(state.loss_params):
        raise KeyError(f"loss parameters differ: {sorted(set(given) ^ set(state.loss_params))}")
    for name, dst in state.loss_params.items():
        if tuple(given[name].shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for loss parameter {name!r}")
        dst.copy_(torch.tensor(given[name], dtype=dst.dtype))
    moments = {}
    for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        moments[ours] = {}
        for path, value in flatten_variables(tree["opt_state"][theirs]).items():
            key, perm = _trainable_key(path)
            value = value if perm is None else value.transpose(perm)
            moments[ours][key] = torch.tensor(value, dtype=torch.float32)
    # the optimizer raises on a missing or extra name and on a shape that differs
    state.optimizer.load_state_dict({"count": int(tree["opt_state"]["count"]), **moments})
    state.step = int(tree["step"])
    return state
