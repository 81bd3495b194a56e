"""Process-group bootstrap and this process's share of a global batch.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/distributed.py``.
The reference initialises ``jax.distributed`` from ``JAX_*`` variables and
is a no-op for one process. Here each process drives one device, and a
collective needs a process group even in one process, so:

- under ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``) or with an explicit ``init_method``, :func:`initialize` joins
  that group;
- with neither, it sets up a group of this process alone (world size 1) on
  an in-memory store, so that the mesh functions work alike in one process.

The backend follows the device asked for: NCCL for CUDA, gloo for the CPU.
CUDA where no card is present raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from pwclonet_pylidarslam_torch.device import resolve_device

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> None:
    """Join (or set up) the default process group for ``device`` (CUDA
    unless the caller asks for the CPU): NCCL on CUDA, each rank on card
    ``LOCAL_RANK`` (else its rank modulo the cards), gloo on the CPU.

    ``init_method``, ``world_size`` and ``rank`` default to torchrun's
    variables; with none of those set, the group is this process alone on an
    in-memory store. A second call with a group of the same backend returns;
    one of another backend raises."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} process group is set up; "
                             f"device {dev} needs {backend}")
        return
    env = os.environ
    if init_method is None and all(v in env for v in _TORCHRUN_VARS):
        init_method = "env://"
    if init_method is not None:
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(env["RANK"]) if rank is None else rank
    else:
        world_size, rank = 1, 0
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(dev if dev.index is not None else local)
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)


def shutdown() -> None:
    """Destroy the default process group, where one is set up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> tuple:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of a globally indexed batch (per-rank
    data sharding for the input pipeline); a ``ValueError`` where the batch
    does not divide by the world size."""
    n, rank = _world()
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return slice(rank * per, (rank + 1) * per)


def host_local_devices() -> List[torch.device]:
    """The devices this process drives: its card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]
