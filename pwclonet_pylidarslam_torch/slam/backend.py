"""Pose-graph back end: SE(3) graph optimization on the device.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/slam/backend.py``, with its
semantics:

- edge residual ``log(Z⁻¹ · Xᵢ⁻¹ · Xⱼ)`` against the measurement Z, the pose
  of j in i's frame; unary (GPS-style) priors ``log(Z⁻¹ · Xᵢ)``;
- default information: odometry (|i−j| < 10) trans 2 / rot 5, loop closure
  trans 0.1 / rot 0.5, absolute 1 / 0.001;
- the gauge fixed by anchoring node 0;
- Gauss-Newton steps solved matrix-free: per-edge jacobians by forward-mode
  autodiff (``torch.func.jacfwd`` under ``torch.func.vmap``), then
  block-Jacobi-preconditioned conjugate gradient.

Graphs keep a fixed capacity, with inactive padding, as in the reference.

Accumulation. The reference adds the per-edge terms into per-node rows with
``.at[idx].add`` (edge_i terms, then edge_j, then priors). Here each such sum
is one sum of an ``ops/gather.py::ScatterPlan`` with B=1, N = the node
capacity and the three sets of updates concatenated in that order; the index
is planned once an optimization, so each sum is one launch. On the card its
kernel adds each row's terms in ascending order, so every node sums
its terms in the reference's order and two optimizations agree to the bit
(``index_add_`` adds with float atomics in an order that changes from run to
run, which 500 CG iterations amplify). On the CPU the plain version adds in
the same order. Every per-edge and per-prior term, and every sum, runs over
the graph's active edges and priors only (:func:`_active_part`); the nodes
keep their fixed capacity.

Control flow. The reference runs CG and Gauss-Newton as
``lax.while_loop``s. Here CG runs in chunks of :data:`CG_CHECK_EVERY`
iterations: each iteration computes the update and keeps it only while the
exit condition has not held (``torch.where`` on a device flag, what the
while-loop gives, bit for bit), and the flag is read on the host once a
chunk. Gauss-Newton reads its step flag once an iteration. Every read is
counted in :class:`PGOStats`.

Products run in full fp32: :func:`optimize` turns TF32 off in cuBLAS and
cuDNN and restores the switches after, as the reference runs every einsum at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.ops.gather import ScatterPlan
from pwclonet_pylidarslam_torch.slam.icp_odometry import StepStats, full_fp32_products

# default information diagonals (trans ×3, rot ×3)
ODOMETRY_INFO = (2.0, 2.0, 2.0, 5.0, 5.0, 5.0)
LOOP_INFO = (0.1, 0.1, 0.1, 0.5, 0.5, 0.5)
# GPS/absolute default: 1 m translation confidence, near-zero orientation
# confidence
ABSOLUTE_INFO = (1.0, 1.0, 1.0, 0.001, 0.001, 0.001)

CG_CHECK_EVERY = 16  # CG iterations between two reads of its exit flag


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (V, 4, 4)
    node_active: torch.Tensor  # (V,)
    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,) int32
    edge_meas: torch.Tensor  # (E, 4, 4)  measurement Z: pose of j in i's frame
    edge_info: torch.Tensor  # (E, 6) diagonal information
    edge_active: torch.Tensor  # (E,)
    prior_node: torch.Tensor  # (P,) int32
    prior_meas: torch.Tensor  # (P, 4, 4)  absolute target pose Z
    prior_info: torch.Tensor  # (P, 6) diagonal information
    prior_active: torch.Tensor  # (P,)
    num_nodes: torch.Tensor  # () int32
    num_edges: torch.Tensor  # () int32
    num_priors: torch.Tensor  # () int32


def empty_graph(max_nodes: int, max_edges: int, max_priors: int = 64,
                dtype=torch.float32, device: Union[str, torch.device] = "cuda") -> PoseGraph:
    dev = resolve_device(device)
    eye = torch.eye(4, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return PoseGraph(
        poses=eye.expand(max_nodes, 4, 4).clone(),
        node_active=torch.zeros((max_nodes,), dtype=dtype, device=dev),
        edge_i=torch.zeros((max_edges,), **i32),
        edge_j=torch.zeros((max_edges,), **i32),
        edge_meas=eye.expand(max_edges, 4, 4).clone(),
        edge_info=torch.ones((max_edges, 6), dtype=dtype, device=dev),
        edge_active=torch.zeros((max_edges,), dtype=dtype, device=dev),
        prior_node=torch.zeros((max_priors,), **i32),
        prior_meas=eye.expand(max_priors, 4, 4).clone(),
        prior_info=torch.ones((max_priors, 6), dtype=dtype, device=dev),
        prior_active=torch.zeros((max_priors,), dtype=dtype, device=dev),
        num_nodes=torch.zeros((), **i32),
        num_edges=torch.zeros((), **i32),
        num_priors=torch.zeros((), **i32),
    )


# ---------------------------------------------------------------------------
# Host-side graph building
# ---------------------------------------------------------------------------


class PoseGraphBuilder:
    """Incremental host-side builder (numpy, float64)."""

    def __init__(self, max_nodes: int = 4096, max_edges: int = 8192, max_priors: int = 64):
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.max_priors = max_priors
        self.poses = []
        self.edges = []  # (i, j, meas 4x4, info diag 6)
        self.priors = []  # (i, absolute pose 4x4, info diag 6)

    def add_node(self, pose: np.ndarray) -> int:
        self.poses.append(np.asarray(pose, np.float64))
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, measurement: np.ndarray,
                 information: Optional[np.ndarray] = None):
        """Relative constraint: ``measurement`` = pose of j in i's frame."""
        if information is None:
            diag = ODOMETRY_INFO if abs(i - j) < 10 else LOOP_INFO
            information = np.asarray(diag, np.float64)
        information = np.asarray(information, np.float64)
        if information.ndim == 2:
            information = np.diag(information)
        self.edges.append((i, j, np.asarray(measurement, np.float64), information))

    def add_odometry_edge(self, i: int, relative_pose: np.ndarray, information=None):
        self.add_edge(i, i + 1, relative_pose, information)

    def add_loop_edge(self, i: int, j: int, relative_pose: np.ndarray, information=None):
        self.add_edge(i, j, relative_pose, information)

    def add_absolute_edge(self, i: int, absolute_pose: np.ndarray,
                          information: Optional[np.ndarray] = None):
        """GPS-style unary prior pinning node ``i`` to ``absolute_pose``."""
        if information is None:
            information = np.asarray(ABSOLUTE_INFO, np.float64)
        information = np.asarray(information, np.float64)
        if information.ndim == 2:
            information = np.diag(information)
        self.priors.append((i, np.asarray(absolute_pose, np.float64), information))

    def to_device(self, dtype=torch.float32,
                  device: Union[str, torch.device] = "cuda") -> PoseGraph:
        """The graph at its fixed capacity on ``device``, CUDA unless the
        caller asks for the CPU; the slots past the graph are padding."""
        v, e, p = len(self.poses), len(self.edges), len(self.priors)
        if v > self.max_nodes or e > self.max_edges or p > self.max_priors:
            raise ValueError(
                f"graph ({v} nodes, {e} edges, {p} priors) exceeds capacity "
                f"({self.max_nodes}, {self.max_edges}, {self.max_priors})"
            )
        g = empty_graph(self.max_nodes, self.max_edges, self.max_priors, dtype, device)

        def put(rows, like: torch.Tensor):
            return torch.as_tensor(np.asarray(rows), dtype=like.dtype).to(like.device)

        for rows, fields in ((self.poses, ("poses",)),
                             (self.edges, ("edge_i", "edge_j", "edge_meas", "edge_info")),
                             (self.priors, ("prior_node", "prior_meas", "prior_info"))):
            for k, field in enumerate(fields):
                if rows:
                    column = [x[k] for x in rows] if len(fields) > 1 else rows
                    getattr(g, field)[: len(rows)] = put(column, getattr(g, field))
        g.node_active[:v] = 1.0
        g.edge_active[:e] = 1.0
        g.prior_active[:p] = 1.0
        counts = put([v, e, p], g.num_nodes)
        return g._replace(num_nodes=counts[0], num_edges=counts[1], num_priors=counts[2])


# ---------------------------------------------------------------------------
# Residuals and jacobians
# ---------------------------------------------------------------------------


def edge_residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """SE(3) residual per edge ``(E, 6)``: ``log(Z⁻¹ Xᵢ⁻¹ Xⱼ)``."""
    xi = poses[graph.edge_i.long()]
    xj = poses[graph.edge_j.long()]
    return se3.log(se3.inverse(graph.edge_meas) @ se3.inverse(xi) @ xj)


def prior_residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """Unary prior residual per prior ``(P, 6)``: ``log(Z⁻¹ Xᵢ)``."""
    xi = poses[graph.prior_node.long()]
    return se3.log(se3.inverse(graph.prior_meas) @ xi)


def _edge_residual_of_twists(d: torch.Tensor, xi: torch.Tensor, xj: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
    """One edge's residual with right-perturbed endpoints ``d = (di, dj)``.
    The math runs on a batch of one: under ``jacfwd``, a 0-dim tensor divided
    by a Python float gets a float64 tangent, which ``se3.exp``'s einsum
    then refuses."""
    a = xi @ se3.exp(d[None, :6])[0]
    b = xj @ se3.exp(d[None, 6:])[0]
    return se3.log((se3.inverse(z) @ se3.inverse(a) @ b)[None])[0]


def _prior_residual_of_twist(d: torch.Tensor, xi: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return se3.log((se3.inverse(z) @ (xi @ se3.exp(d[None])[0]))[None])[0]


def edge_jacobians(graph: PoseGraph, poses: torch.Tensor):
    """Per-edge jacobians ``(E, 6, 6)`` of the residual against right
    perturbations of the two endpoints, by forward-mode autodiff per edge."""
    xi = poses[graph.edge_i.long()]
    xj = poses[graph.edge_j.long()]
    zero = torch.zeros(12, dtype=poses.dtype, device=poses.device)
    jac = torch.func.vmap(torch.func.jacfwd(_edge_residual_of_twists),
                          in_dims=(None, 0, 0, 0))(zero, xi, xj, graph.edge_meas)
    return jac[:, :, :6], jac[:, :, 6:]


def prior_jacobians(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """Per-prior jacobian ``(P, 6, 6)`` against a right perturbation of the
    pinned node."""
    xi = poses[graph.prior_node.long()]
    zero = torch.zeros(6, dtype=poses.dtype, device=poses.device)
    return torch.func.vmap(torch.func.jacfwd(_prior_residual_of_twist),
                           in_dims=(None, 0, 0))(zero, xi, graph.prior_meas)


# ---------------------------------------------------------------------------
# Optimization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    """The reference's ``PGOConfig``, whose comments give the reasons."""

    max_iterations: int = 20  # GN outer iterations
    cg_iterations: int = 500
    cg_tolerance: float = 1e-10  # relative preconditioned-residual exit
    damping: float = 1e-6
    step_tolerance: float = 1e-8  # early GN exit when max |dx| drops below
    anchor_first: bool = True  # gauge-fix node 0


class PGOStats(StepStats):
    """What an optimization did on the host: Gauss-Newton iterations, the CG
    iterations of each (those the reference runs; the chunked loop launches
    up to ``CG_CHECK_EVERY - 1`` more, frozen), the CG iterations launched
    and host reads."""

    def __init__(self):
        super().__init__()
        self.gn_iterations = 0
        self.cg_iterations: List[int] = []
        self.cg_launched = 0


class _Accumulator:
    """Per-node sums of the edge_i, edge_j and prior terms, in that order,
    as one row scatter-add: ``(E, C), (E, C), (P, C) → (V, C)``; then
    ``reduce`` (the sum over the processes that hold the other edges,
    ``parallel/sharded_backend.py``) where given. The index is planned once,
    on the graph's device: each sum is then one launch of the kernel."""

    def __init__(self, graph: PoseGraph,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.n = graph.poses.shape[0]
        self.idx = torch.cat([graph.edge_i, graph.edge_j, graph.prior_node]).to(torch.int32)[None]
        self.plan = ScatterPlan(self.idx, self.n)
        self.reduce = reduce

    def __call__(self, yi: torch.Tensor, yj: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
        upd = torch.cat([yi, yj, yp])
        out = self.plan.sum(upd.reshape(1, self.idx.shape[1], -1))[0]
        return out if self.reduce is None else self.reduce(out)


def _part(graph: PoseGraph, edges: slice, priors: slice) -> PoseGraph:
    """The graph's edges ``edges`` and priors ``priors``, its nodes at full
    capacity."""
    return graph._replace(
        edge_i=graph.edge_i[edges], edge_j=graph.edge_j[edges], edge_meas=graph.edge_meas[edges],
        edge_info=graph.edge_info[edges], edge_active=graph.edge_active[edges],
        prior_node=graph.prior_node[priors], prior_meas=graph.prior_meas[priors],
        prior_info=graph.prior_info[priors], prior_active=graph.prior_active[priors])


def _active_part(graph: PoseGraph, e: int, p: int) -> PoseGraph:
    """The graph's first ``e`` edges and ``p`` priors, its nodes at full
    capacity. A padded slot's every term is an exact zero (its information
    is 0), and a zero added to a sum started at +0.0 changes none of its
    bits, so an optimization of this part gives the poses the reference
    gives over the whole capacity. Over the whole capacity every padded slot
    would point at node 0, whose terms the scatter-add kernel adds in one
    thread: ~33,000 zeros every CG iteration at the default capacity."""
    return _part(graph, slice(0, e), slice(0, p))


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("eab,eb->ea")``."""
    return (m @ v[..., None])[..., 0]


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("eba,eb->ea")``."""
    return (m.transpose(-1, -2) @ v[..., None])[..., 0]


def _gn_iter(graph: PoseGraph, poses: torch.Tensor, free: torch.Tensor, acc: _Accumulator,
             config: PGOConfig, stats: PGOStats):
    ei, ej, pn = graph.edge_i.long(), graph.edge_j.long(), graph.prior_node.long()
    res = edge_residuals(graph, poses)  # (E, 6)
    ji, jj = edge_jacobians(graph, poses)  # (E, 6, 6) each
    info = graph.edge_info * graph.edge_active[:, None]  # (E, 6)
    pres = prior_residuals(graph, poses)  # (P, 6)
    jp = prior_jacobians(graph, poses)  # (P, 6, 6)
    pinfo = graph.prior_info * graph.prior_active[:, None]  # (P, 6)
    free_col = free[:, None]

    def h_matvec(v):  # v: (V, 6)
        u = (_mv(ji, v[ei]) + _mv(jj, v[ej])) * info
        up = _mv(jp, v[pn]) * pinfo
        y = acc(_mtv(ji, u), _mtv(jj, u), _mtv(jp, up))
        return y * free_col + config.damping * v

    # gradient g = Jᵀ W r (binary edges + unary priors)
    wr = res * info
    g = acc(_mtv(ji, wr), _mtv(jj, wr), _mtv(jp, pres * pinfo)) * free_col

    # block-Jacobi preconditioner: per-node 6x6 diagonal blocks
    hii = ji.transpose(-1, -2) @ (ji * info[:, :, None])
    hjj = jj.transpose(-1, -2) @ (jj * info[:, :, None])
    hpp = jp.transpose(-1, -2) @ (jp * pinfo[:, :, None])
    v = poses.shape[0]
    diag = acc(hii.reshape(-1, 36), hjj.reshape(-1, 36), hpp.reshape(-1, 36)).reshape(v, 6, 6)
    diag = diag + torch.eye(6, dtype=poses.dtype, device=poses.device) * (config.damping + 1e-8)
    diag_inv = torch.linalg.inv_ex(diag).inverse  # no error check: no sync

    def precond(r):
        return _mv(diag_inv, r) * free_col

    # preconditioned CG for H dx = -g, exiting once rᵀz <= tol · r0ᵀz0; the
    # state stops changing at the iteration where the reference's loop exits
    x = torch.zeros_like(g)
    r = -g
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    limit = config.cg_tolerance * rz
    active = torch.ones((), dtype=torch.bool, device=g.device)
    ran = torch.zeros((), dtype=torch.int32, device=g.device)
    it = ran_so_far = 0
    while it < config.cg_iterations:
        for _ in range(min(CG_CHECK_EVERY, config.cg_iterations - it)):
            active = active & (rz > limit)
            hp = h_matvec(p)
            alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-20)
            x_new = x + alpha * p
            r_new = r - alpha * hp
            z_new = precond(r_new)
            rz_new = torch.sum(r_new * z_new)
            beta = rz_new / torch.clamp_min(rz, 1e-20)
            p_new = z_new + beta * p
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            z = torch.where(active, z_new, z)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            ran = ran + active.to(torch.int32)
            it += 1
            stats.cg_launched += 1
        going, ran_so_far = stats.read(torch.stack([(active & (rz > limit)).to(torch.int32), ran]))
        if not going:
            break
    stats.cg_iterations.append(int(ran_so_far))

    # apply the right-perturbation update to the free nodes
    dx = x * free_col
    return poses @ se3.exp(dx), torch.amax(torch.abs(dx))


def optimize(graph: PoseGraph, config: PGOConfig = PGOConfig(),
             stats: Optional[PGOStats] = None) -> PoseGraph:
    """Gauss-Newton pose-graph optimization; returns the graph with updated
    poses. Node 0 is the gauge anchor (held fixed) unless
    ``config.anchor_first`` is False. Exits once the GN step's max ``|dx|``
    drops to ``step_tolerance``. ``stats`` (a :class:`PGOStats`) counts
    iterations and host reads. On the card the graph must be float32 (the
    scatter-add kernel's type)."""
    return _optimize(graph, config, stats, _active_part)


def _optimize(graph: PoseGraph, config: PGOConfig, stats: Optional[PGOStats],
              part: Callable[[PoseGraph, int, int], PoseGraph],
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> PoseGraph:
    """:func:`optimize` over ``part(graph, e, p)`` of the graph with ``e``
    edges and ``p`` priors, its per-node sums then ``reduce``d where given.
    Every host read is of a value computed from reduced sums, so processes
    that hold the other parts read the same values and leave their loops
    together."""
    stats = stats if stats is not None else PGOStats()
    with full_fp32_products():
        v = graph.poses.shape[0]
        free = graph.node_active
        if config.anchor_first:
            free = free * (torch.arange(v, device=free.device) != 0)
        e, p = stats.read(torch.stack([graph.num_edges, graph.num_priors]))
        active = part(graph, e, p)
        acc = _Accumulator(active, reduce)
        poses = graph.poses
        it = 0
        while it < config.max_iterations:
            poses, step = _gn_iter(active, poses, free, acc, config, stats)
            it += 1
            stats.gn_iterations += 1
            if not stats.read(step > config.step_tolerance):
                break
        return graph._replace(poses=se3.normalize(poses))


def graph_cost(graph: PoseGraph, poses: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total weighted squared residual (for tests / monitoring)."""
    p = graph.poses if poses is None else poses
    res = edge_residuals(graph, p)
    cost = torch.sum(res * res * graph.edge_info * graph.edge_active[:, None])
    pres = prior_residuals(graph, p)
    return cost + torch.sum(pres * pres * graph.prior_info * graph.prior_active[:, None])
