"""Data-parallel PWCLO-Net training over the ``data`` axis of a mesh.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/data_parallel.py``,
where the single-device train step runs under GSPMD with the batch split
over ``data`` and the state replicated. Here every rank holds the whole
state and calls the step with the same global batch; the step:

- takes the rank's contiguous block of rows (:func:`shard_batch`; a batch
  that does not divide is refused);
- runs ``train/state.py::loss_and_grads`` on it under
  ``models/layers.py::sharded_batch``: each BatchNorm takes the moments of
  the whole batch (all-reduced, differentiably), and the dropout masks are
  drawn for the whole batch from the state's generator, of which the rank
  keeps its rows, so every rank's generator advances as one process's;
- averages the gradients and the loss terms over the axis (one all-reduce);
- applies ``train/state.py::apply_grads``: the same Adam update, non-finite
  skip and committed statistics on every rank.

Against ``train_step`` on the whole batch in one process, the loss agrees
within rtol 1e-4 and the parameters after the step within 1e-4 at the 99.9th
percentile and 1e-2 at most, the reference's bar: the sums of the moments
and the gradients are taken in another order, even on one rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh

from pwclonet_pylidarslam_torch.models.layers import sharded_batch
from pwclonet_pylidarslam_torch.parallel.mesh import (
    all_reduce_sum,
    batch_sharding,
    mesh_axis,
    replicated,
)
from pwclonet_pylidarslam_torch.train.state import (
    TrainConfig,
    TrainState,
    apply_grads,
    loss_and_grads,
)


def shard_batch(batch: Mapping, mesh: DeviceMesh) -> Dict:
    """This rank's rows of a global batch, its leading axis split over
    ``data``; a ``ValueError`` where it does not divide."""
    sharding = batch_sharding(mesh)
    return {k: sharding.place(v) for k, v in batch.items()}


@torch.no_grad()
def replicate_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """``state`` made equal on every rank of the mesh, in place: the
    network's parameters and statistics, the loss parameters, the optimizer
    and the dropout generator, broadcast from the first rank of ``data``.
    Returns ``state``."""
    sharding = replicated(mesh)
    opt = state.optimizer
    for t in (list(state.model.state_dict().values()) + list(state.loss_params.values())
              + [opt.exp_avg, opt.exp_avg_sq, opt.count]):
        sharding.place(t)
    if state.generator is not None:
        seed = sharding.place(state.generator.get_state().to(state.device))
        state.generator.set_state(seed.cpu())
    return state


def make_parallel_train_step(config: TrainConfig, mesh: DeviceMesh) -> Callable:
    """``step(state, batch) -> log``: ``train/state.py::train_step`` with the
    batch split over the mesh's ``data`` axis. Every rank calls it with its
    replicated state and the same global batch (numpy or tensors), whose
    leading dimension must divide by the axis."""
    ax = mesh_axis(mesh, "data")

    def step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
        rows = shard_batch(batch, mesh)
        with sharded_batch(state.model, ax):
            _, log, grads = loss_and_grads(config, state, rows)
        # the loss parameters' log entries are the same on every rank
        terms = [k for k in log if not k.startswith("s_param")]
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [torch.stack([log[k] for k in terms])])
        flat = all_reduce_sum(flat, ax.group) / ax.size
        parts = flat.split([g.numel() for g in grads.values()] + [len(terms)])
        grads = {k: p.view_as(g) for (k, g), p in zip(grads.items(), parts)}
        log.update(zip(terms, parts[-1].unbind()))
        return apply_grads(config, state, log["loss"], log, grads)

    return step
