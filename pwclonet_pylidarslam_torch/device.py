"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and no card
    is available, instead of running somewhere the caller did not ask for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
