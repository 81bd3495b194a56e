"""Device meshes over the ranks of a ``torch.distributed`` group.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/mesh.py``. The
reference lays its devices out in a ``jax.sharding.Mesh`` with the axes
``("data", "model")`` and lets GSPMD insert the collectives. Here each rank
is a process with one device, a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the first ranks of the
world, and the sharded functions of this package (SPMD: every rank calls
them with the same global inputs) take their share by their coordinate on a
mesh axis and join the ranks' results with collectives on that axis's
group.

Axes: ``data`` splits batches, frames, points, edges or hash rows;
``model`` is reserved, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.models.layers import BatchShard, all_gather_single
from pwclonet_pylidarslam_torch.parallel.distributed import initialize

AXES = ("data", "model")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Union[str, torch.device] = "cuda") -> DeviceMesh:
    """Mesh of shape ``(n_data, n_model)`` with axes ``("data", "model")``
    over ranks ``0 .. n_data·n_model − 1`` of the world, on ``device``'s
    type (CUDA unless the caller asks for the CPU). ``n_data`` defaults to
    the world size over ``n_model``. Where no process group is set up,
    :func:`~parallel.distributed.initialize` sets up one of this process
    alone. Every rank of the world calls it: the mesh's groups are made
    collectively."""
    dev = resolve_device(device)
    initialize(device=dev)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {world}")
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)


def mesh_axis(mesh: DeviceMesh, axis: str = "data") -> BatchShard:
    """One axis of a mesh as this rank sees it: the group of the ranks that
    share its other coordinates, this rank's place on the axis and its
    length."""
    sub = mesh[axis]
    return BatchShard(sub.get_group(), sub.get_local_rank(), sub.size())


def axis_rows(n: int, ax: BatchShard, what: str) -> slice:
    """This rank's contiguous block of ``n`` rows split over ``ax``; a
    ``ValueError`` where ``n`` does not divide."""
    if n % ax.size != 0:
        raise ValueError(f"{what} {n} not divisible by mesh axis of size {ax.size}")
    return ax.rows(n // ax.size)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, in place on a
    contiguous ``x`` (at one rank, ``x`` unchanged)."""
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, ax: BatchShard) -> torch.Tensor:
    """The ranks' ``x`` stacked in rank order on a new leading axis:
    ``(size,) + x.shape``."""
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    all_gather_single(out, x.contiguous(), group=ax.group)
    return out.reshape((ax.size,) + tuple(x.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: its leading axis split over the mesh
    axis ``axis`` in contiguous blocks, or, with ``axis`` None, whole and
    equal on every rank."""

    mesh: DeviceMesh
    axis: Optional[str]

    def place(self, x):
        """This rank's part of ``x``, which every rank passes whole: the
        rows of its block (a ``ValueError`` where the leading axis does not
        divide); or, replicated, a tensor ``x`` made equal on every rank
        (broadcast in place from the first rank of the ``data`` axis)."""
        if self.axis is not None:
            return x[axis_rows(len(x), mesh_axis(self.mesh, self.axis), "leading axis")]
        ax = mesh_axis(self.mesh, "data")
        dist.broadcast(x, src=dist.get_global_rank(ax.group, 0), group=ax.group)
        return x


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Leading axis split over ``data``, the rest whole."""
    return Sharding(mesh, "data")


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, None)
