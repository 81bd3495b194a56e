"""Edge-sharded pose-graph optimization over the ranks of a mesh axis.

PyTorch counterpart of
``pwclonet_pylidarslam_tpu/parallel/sharded_backend.py``. The matrix-free
Gauss-Newton of ``slam/backend.py`` is built from per-edge work (residuals,
jacobians, H·v products) summed into per-node rows. Here the edges and the
priors are split over the axis in contiguous ranges of their capacity and
the nodes (V × 4 × 4) are replicated. Each rank runs the back end's own
step over the active part of its ranges (jacobians by ``torch.func.jacfwd``,
per-node sums through ``ops/gather.py::scatter_add_rows``, the scatter-add
kernel on CUDA), and every per-node sum (the gradient, each H·v product, the
block diagonal) is then all-reduced. Every value the loops read on the host
comes from those sums, so all ranks leave each loop together.

On one rank the result is ``backend.optimize``'s, bit for bit. On more, a
node's sum adds the ranks' partial sums, in another order than the one pass
of a single process: the poses agree with ``optimize``'s within 5e-6 and the
cost within rtol 1e-9 in float64, the reference's bar for its own sharded
optimization (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from pwclonet_pylidarslam_torch.parallel.mesh import all_reduce_sum, axis_rows, mesh_axis
from pwclonet_pylidarslam_torch.slam.backend import (
    PGOConfig,
    PGOStats,
    PoseGraph,
    _optimize,
    _part,
)


def optimize_sharded(graph: PoseGraph, mesh: DeviceMesh, config: PGOConfig = PGOConfig(),
                     axis: str = "data", stats: Optional[PGOStats] = None) -> PoseGraph:
    """Drop-in for ``backend.optimize`` with the edges and priors split over
    ``mesh`` axis ``axis``; a ``ValueError`` where the edge or the prior
    capacity does not divide by the axis. Every rank calls it with the same
    graph and gets the same poses."""
    ax = mesh_axis(mesh, axis)
    edges = axis_rows(graph.edge_i.shape[0], ax, "edge capacity")
    priors = axis_rows(graph.prior_node.shape[0], ax, "prior capacity")

    def active_range(full: slice, count: int) -> slice:
        return slice(full.start, min(full.stop, max(full.start, count)))

    def part(g: PoseGraph, e: int, p: int) -> PoseGraph:
        return _part(g, active_range(edges, e), active_range(priors, p))

    return _optimize(graph, config, stats, part,
                     functools.partial(all_reduce_sum, group=ax.group))
