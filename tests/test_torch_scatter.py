"""Port parity: the row scatter-add (the gather's backward) of
``pwclonet_pylidarslam_torch.ops.gather`` against the reference's
``scatter_add_rows`` (its Pallas kernel in interpret mode) and against
``.at[].add``, and the gather's gradient against ``jax.grad``; a
``ScatterPlan`` reused over many update tensors, and the pose-graph back
end's one plan an optimization. On the CPU the port runs its plain
versions; the CUDA kernel is held against them on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pgo_fixtures import circle_poses, drifted_odometry
from pwclonet_pylidarslam_torch import ops
from pwclonet_pylidarslam_torch import parallel as tpar
from pwclonet_pylidarslam_torch.ops import gather as tgather
from pwclonet_pylidarslam_torch.ops.gather import scatter_add_rows_plain
from pwclonet_pylidarslam_torch.slam import backend as tb
from pwclonet_pylidarslam_tpu.ops.gather import gather_points as j_gather_points
from pwclonet_pylidarslam_tpu.ops.pallas.gather_kernel import scatter_add_rows as j_scatter_add_rows


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Test workers run side by side: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, b, n, m, c, targets=None):
    rng = np.random.default_rng(seed)
    upd = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = rng.integers(0, n if targets is None else targets, size=(b, m)).astype(np.int32)
    return upd, idx


# the shapes of the reference's own scatter and gradient tests, one with M no
# multiple of 128 (the reference then takes its .at[].add fallback), one with
# a heavily repeated index (three rows take all 640 updates), and a skewed one
# whose segments run past a warp's 32 (five rows take ~260 updates each)
@pytest.mark.parametrize("b,n,m,c,targets", [
    (2, 128, 256, 5, None), (2, 64, 128, 4, None), (2, 100, 333, 7, None), (2, 64, 640, 6, 3),
    (2, 16, 1280, 3, 5),
])
def test_scatter_add_matches_reference(b, n, m, c, targets):
    upd, idx = _case(1, b, n, m, c, targets)
    kernel = np.asarray(j_scatter_add_rows(jnp.asarray(upd), jnp.asarray(idx), n, interpret=True))
    oracle = np.asarray(jnp.zeros((b, n, c), jnp.float32).at[
        jnp.arange(b)[:, None], jnp.asarray(idx)].add(jnp.asarray(upd)))
    planned = tgather.ScatterPlan(torch.from_numpy(idx), n).sum
    for fn in (scatter_add_rows_plain, ops.scatter_add_rows, lambda u, i, n: planned(u)):
        out = fn(torch.from_numpy(upd), torch.from_numpy(idx), n).numpy()
        assert out.shape == (b, n, c) and out.dtype == np.float32
        # sums of up to a few hundred unit-scale terms in another order
        np.testing.assert_allclose(out, kernel, atol=1e-5 * max(1.0, m / n / 8))
        np.testing.assert_allclose(out, oracle, atol=1e-5 * max(1.0, m / n / 8))


def test_scatter_add_is_a_sequential_loop_over_m():
    """The order the CUDA kernel promises is the plain version's on the CPU:
    rows of one destination are added in ascending m, starting from zero."""
    upd, idx = _case(2, 2, 16, 200, 3)
    want = np.zeros((2, 16, 3), np.float32)
    for b in range(2):
        for m in range(200):
            want[b, idx[b, m]] += upd[b, m]
    out = scatter_add_rows_plain(torch.from_numpy(upd), torch.from_numpy(idx), 16).numpy()
    np.testing.assert_array_equal(out, want)


def test_gather_gradient_matches_jax_grad():
    rng = np.random.default_rng(2)
    b, n, m, c = 2, 64, 128, 4
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m)).astype(np.int32)
    want = jax.grad(lambda p: jnp.sum(j_gather_points(p, jnp.asarray(idx)) ** 2))(jnp.asarray(src))
    t_src = torch.from_numpy(src).requires_grad_()
    t_idx = torch.from_numpy(idx)
    (ops.gather_points(t_src, t_idx) ** 2).sum().backward()
    np.testing.assert_allclose(t_src.grad.numpy(), np.asarray(want), atol=1e-5)
    assert t_idx.grad is None and not t_idx.requires_grad
    # the gradient is the scatter-add of the incoming gradient
    gathered = ops.gather_points(t_src.detach(), t_idx)
    torch.testing.assert_close(t_src.grad, ops.scatter_add_rows(2.0 * gathered, t_idx, n),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_cpu_gather_gradient_equals_torch_gathers(dtype):
    """On the CPU the gather's gradient is the plain scatter-add through a
    ``ScatterPlan``: to the bit what ``torch.gather``'s own backward gives,
    since both add a row's updates in ascending m."""
    b, n, m, c = 3, 1000, 8192, 19
    gen = torch.Generator().manual_seed(4)
    src = torch.randn(b, n, c, generator=gen).to(dtype).requires_grad_()
    idx = torch.randint(0, n, (b, m), generator=gen, dtype=torch.int32)
    upd = torch.randn(b, m, c, generator=gen).to(dtype)
    (got,) = torch.autograd.grad(ops.gather_points(src, idx), src, upd)
    plain = src.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(tgather.gather_points_plain(plain, idx), plain, upd)
    assert torch.equal(got, want)


def test_grouping_gradient_through_one_concatenated_gather():
    """``group_points_multi`` differentiates into each of its sources."""
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.normal(size=(2, 32, 3)).astype(np.float32)).requires_grad_()
    feat = torch.from_numpy(rng.normal(size=(2, 32, 5)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 32, size=(2, 10, 4)).astype(np.int32))
    g_xyz, g_feat = ops.group_points_multi(idx, xyz, feat)
    (g_xyz.sum() * 2.0 + (g_feat ** 2).sum()).backward()
    counts = scatter_add_rows_plain(torch.ones(2, 40, 1), idx.reshape(2, 40), 32)
    torch.testing.assert_close(xyz.grad, (2.0 * counts).expand(2, 32, 3))
    torch.testing.assert_close(feat.grad, 2.0 * feat.detach() * counts)


def test_knn_and_fps_results_never_require_grad():
    pts = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(0)).requires_grad_()
    moved = pts * 1.5 + 0.1  # a point set with a graph behind it, like the warped points
    dists, idx = ops.knn(moved, pts, 4)
    picks = ops.furthest_point_sample(moved, 8)
    assert not dists.requires_grad and dists.grad_fn is None
    assert not idx.requires_grad and not picks.requires_grad
    assert idx.dtype == picks.dtype == torch.int32


# M no multiple of 128 (the reference's scatter_add_rows then takes its
# .at[].add; its Pallas kernel is held against the plan above), a heavily
# repeated index, and the back end's shape: few terms into many rows
@pytest.mark.parametrize("b,n,m,c,targets", [
    (2, 100, 333, 7, None), (2, 64, 650, 6, 3), (2, 16, 1290, 3, 5), (1, 512, 200, 6, 100),
])
def test_scatter_plan_reused_matches_plain_and_reference(b, n, m, c, targets):
    """A plan summing several update tensors over one index (of other
    widths too): each sum the plain version to the bit, and the reference's
    ``scatter_add_rows`` at this file's tolerance."""
    _, idx = _case(4, b, n, m, c, targets)
    plan = tgather.ScatterPlan(torch.from_numpy(idx), n)
    for seed, width in ((5, c), (6, c), (7, 1), (8, 36)):
        upd = np.random.default_rng(seed).normal(size=(b, m, width)).astype(np.float32)
        out = plan.sum(torch.from_numpy(upd))
        assert torch.equal(out, scatter_add_rows_plain(torch.from_numpy(upd),
                                                       torch.from_numpy(idx), n))
        ref = j_scatter_add_rows(jnp.asarray(upd), jnp.asarray(idx), n, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5 * max(1.0, m / n / 8))


@pytest.mark.parametrize("kind", ["uniform", "three rows", "as many long rows as fit",
                                  "one row takes all"])
def test_long_rows_fit_the_plans_list(kind):
    """The plan lists the rows of more than ``LONG_ROW`` updates in room for
    ``b * (m // (LONG_ROW + 1))``: each takes at least ``LONG_ROW + 1`` of
    its sample's m updates, so no index lists more, even one that gives as
    many rows as it can just that many."""
    rng = np.random.default_rng(9)
    b, n, m = 3, 50, 700
    tile, _, room = tgather.scatter_plan_sizes(b, n, m)
    per = tgather.LONG_ROW + 1
    assert tile == 256 and room == b * (m // per) == 15
    if kind == "uniform":
        idx = rng.integers(0, n, size=(b, m))
    elif kind == "three rows":
        idx = rng.integers(0, 3, size=(b, m))
    elif kind == "as many long rows as fit":  # rows of exactly LONG_ROW + 1, the rest on one
        full = np.repeat(np.arange(m // per) % n, per)
        worst = np.concatenate([full, np.full(m - full.size, n - 1)])
        idx = np.stack([rng.permutation(worst) for _ in range(b)])
    else:
        idx = np.full((b, m), 7)
    counts = np.stack([np.bincount(row, minlength=n) for row in idx])
    assert (counts > tgather.LONG_ROW).sum() <= room


def test_scatter_plan_refuses_what_it_cannot_take():
    idx = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n must be"):
        tgather.ScatterPlan(idx, 0)
    with pytest.raises(ValueError, match="CPU"):  # no copy across devices
        tgather.ScatterPlan(idx, 4).sum(torch.zeros(1, 4, 3, device="meta"))


def _pose_graph(dtype, priors=(5, 30)):
    rng = np.random.default_rng(0)
    gt = circle_poses(40)
    drifted, rels = drifted_odometry(gt, rng)
    b = tb.PoseGraphBuilder(max_nodes=64, max_edges=128, max_priors=8)
    for p in drifted:
        b.add_node(p)
    for i, r in enumerate(rels):
        b.add_odometry_edge(i, r)
    b.add_loop_edge(0, len(gt) - 1, np.linalg.inv(gt[0]) @ gt[-1])
    for i in priors:
        b.add_absolute_edge(i, gt[i])
    return b.to_device(dtype, device="cpu")


def _count_plans_and_sums(monkeypatch) -> tuple:
    plans, sums = [], []
    real_init, real_sum = tgather.ScatterPlan.__init__, tgather.ScatterPlan.sum

    def init(self, *args, **kwargs):
        plans.append(args[0].shape)
        real_init(self, *args, **kwargs)

    def total(self, updates):
        sums.append(updates.shape)
        return real_sum(self, updates)

    monkeypatch.setattr(tgather.ScatterPlan, "__init__", init)
    monkeypatch.setattr(tgather.ScatterPlan, "sum", total)
    return plans, sums


def _one_call_an_accumulation(self, yi, yj, yp):
    """The accumulation as the back end ran it before it kept a plan: one
    ``scatter_add_rows`` (a plan and a sum) each."""
    upd = torch.cat([yi, yj, yp])
    out = tgather.scatter_add_rows(upd.reshape(1, self.idx.shape[1], -1), self.idx, self.n)[0]
    return out if self.reduce is None else self.reduce(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backend_plans_once_an_optimization(monkeypatch, dtype):
    """``optimize`` plans its index once and sums each accumulation over the
    plan: 2 sums a Gauss-Newton iteration and 1 a CG iteration launched
    (what the card's launch counts hold, a sum one launch); its poses are
    those of one ``scatter_add_rows`` call an accumulation, to the bit."""
    graph = _pose_graph(dtype)
    cfg = tb.PGOConfig(max_iterations=5)
    plans, sums = _count_plans_and_sums(monkeypatch)
    stats = tb.PGOStats()
    planned = tb.optimize(graph, cfg, stats)
    e, p = int(graph.num_edges), int(graph.num_priors)
    assert plans == [(1, 2 * e + p)]
    assert len(sums) == 2 * stats.gn_iterations + stats.cg_launched > 2
    monkeypatch.undo()
    monkeypatch.setattr(tb._Accumulator, "__call__", _one_call_an_accumulation)
    assert torch.equal(tb.optimize(graph, cfg).poses, planned.poses)


@pytest.fixture(scope="module")
def mesh1():
    """A mesh of this process alone on a group that it sets up, destroyed
    after the module."""
    started = not dist.is_initialized()
    mesh = tpar.make_mesh(device="cpu")
    yield mesh
    if started:
        tpar.shutdown()


def test_sharded_backend_plans_once_an_optimization(mesh1, monkeypatch):
    """``optimize_sharded`` goes through the same accumulator: one plan of
    its rank's edges and priors, one sum an accumulation, and on one rank
    the poses of ``optimize`` to the bit."""
    graph = _pose_graph(torch.float64)
    cfg = tb.PGOConfig(max_iterations=5)
    ref = tb.optimize(graph, cfg)
    plans, sums = _count_plans_and_sums(monkeypatch)
    stats = tb.PGOStats()
    got = tpar.optimize_sharded(graph, mesh1, cfg, stats=stats)
    assert len(plans) == 1 and len(sums) == 2 * stats.gn_iterations + stats.cg_launched
    assert torch.equal(got.poses, ref.poses)
