"""The pose-graph back end of the port against the reference on the CPU,
mirroring the default lane of ``tests/test_backend.py``: the same graphs
(the circle of ``tests/pgo_fixtures.py``, GPS-style priors, padding) go
through both.

Tolerances, and why:
- residuals and ``graph_cost`` to 1e-6 (the same float expressions, libm);
  in float32, plus 4 ulp of the largest coordinate (40 m on the circle):
  the 4x4 products are summed in another order than XLA's dots;
- jacobians to 1e-5 (forward-mode autodiff of those expressions in either
  framework);
- one Gauss-Newton iteration (with its full CG) to 1e-5;
- the full circle optimization to 1e-4, or to 3x the reference's own
  spread when its input poses move by one float32 ulp, if that is larger
  (its CG runs up to 500 iterations, and sums taken in another order move
  the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgo_fixtures import circle_poses, drifted_odometry
from pwclonet_pylidarslam_torch.ops.gather import scatter_add_rows_plain
from pwclonet_pylidarslam_torch.slam import backend as tb
from pwclonet_pylidarslam_tpu.core import se3 as jse3
from pwclonet_pylidarslam_tpu.slam import backend as jb

DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}


def _builders(gt, drifted, rels, loop=True, priors=(), max_nodes=64, max_edges=128,
              max_priors=8):
    out = []
    for mod in (jb, tb):
        b = mod.PoseGraphBuilder(max_nodes=max_nodes, max_edges=max_edges, max_priors=max_priors)
        for p in drifted:
            b.add_node(p)
        for i, r in enumerate(rels):
            b.add_odometry_edge(i, r)
        n = len(gt)
        if loop:
            b.add_loop_edge(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1])
        for i in priors:
            b.add_absolute_edge(i, gt[i])
        out.append(b)
    return out


def _graphs(builders, dtype):
    tdt, jdt = DTYPES[dtype]
    return builders[0].to_device(jdt), builders[1].to_device(tdt, device="cpu")


def _atol(dtype, base, graph):
    """``base``, plus 4 ulp of the largest translation in float32."""
    if dtype == "float64":
        return base
    return base + 4 * float(np.spacing(np.float32(np.abs(N(graph.poses[:, :3, 3])).max())))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def circle():
    rng = np.random.default_rng(0)
    gt = circle_poses(60)
    drifted, rels = drifted_odometry(gt, rng)
    return gt, drifted, rels


@pytest.mark.parametrize("dtype", DTYPES)
def test_residuals_and_cost_match_reference(circle, dtype):
    gt, drifted, rels = circle
    jg, tg = _graphs(_builders(gt, drifted, rels, priors=(20, 40)), dtype)
    atol = _atol(dtype, 1e-6, tg)
    np.testing.assert_allclose(N(tb.edge_residuals(tg, tg.poses)),
                               N(jax.jit(jb.edge_residuals)(jg, jg.poses)), atol=atol, rtol=0)
    np.testing.assert_allclose(N(tb.prior_residuals(tg, tg.poses)),
                               N(jax.jit(jb.prior_residuals)(jg, jg.poses)), atol=atol, rtol=0)
    np.testing.assert_allclose(float(tb.graph_cost(tg)), float(jax.jit(jb.graph_cost)(jg)),
                               rtol=1e-6)
    for name in jb.PoseGraph._fields:
        np.testing.assert_array_equal(N(getattr(tg, name)), N(getattr(jg, name)), err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobians_match_reference(circle, dtype):
    gt, drifted, rels = circle
    jg, tg = _graphs(_builders(gt, drifted, rels, priors=(20, 40)), dtype)
    ji, jj = jax.jit(jb._edge_jacobians_dense)(jg, jg.poses)
    ti, tj = tb.edge_jacobians(tg, tg.poses)
    np.testing.assert_allclose(N(ti), N(ji), atol=1e-5, rtol=0)
    np.testing.assert_allclose(N(tj), N(jj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(N(tb.prior_jacobians(tg, tg.poses)),
                               N(jax.jit(jb._prior_jacobians_dense)(jg, jg.poses)),
                               atol=1e-5, rtol=0)
    # the jacobian is a derivative: against central differences of the residual
    d = 1e-4 if dtype == "float64" else 1e-2
    e = 7  # an odometry edge between nodes 7 and 8
    xi, xj, z = tg.poses[7].double(), tg.poses[8].double(), tg.edge_meas[e].double()
    num = []
    for k in range(12):
        step = torch.zeros(12, dtype=torch.float64)
        step[k] = d
        num.append((tb._edge_residual_of_twists(step, xi, xj, z)
                    - tb._edge_residual_of_twists(-step, xi, xj, z)) / (2 * d))
    num = torch.stack(num, dim=1)
    np.testing.assert_allclose(N(torch.cat([ti[e], tj[e]], dim=1)), N(num), atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_gauss_newton_iteration_matches_reference(circle, dtype):
    gt, drifted, rels = circle
    jg, tg = _graphs(_builders(gt, drifted, rels, priors=(30,)), dtype)
    ref = jb.optimize(jg, jb.PGOConfig(max_iterations=1))
    stats = tb.PGOStats()
    got = tb.optimize(tg, tb.PGOConfig(max_iterations=1), stats)
    np.testing.assert_allclose(N(got.poses), N(ref.poses), atol=1e-5, rtol=0)
    assert stats.gn_iterations == 1 and len(stats.cg_iterations) == 1
    # whole chunks up to the one in which CG's exit held
    chunk = tb.CG_CHECK_EVERY
    assert stats.cg_launched == min(500, -(-stats.cg_iterations[0] // chunk) * chunk)
    # the graph's counts, one read a chunk of CG iterations, one for the step
    assert stats.host_reads == 1 + -(-stats.cg_launched // tb.CG_CHECK_EVERY) + 1


def test_chunked_cg_equals_the_while_loop(circle, monkeypatch):
    """Freezing the CG state once its exit condition holds gives what a read
    every iteration gives, bit for bit."""
    gt, drifted, rels = circle
    _, tg = _graphs(_builders(gt, drifted, rels), "float32")
    cfg = tb.PGOConfig(max_iterations=3)
    chunked = tb.optimize(tg, cfg)
    monkeypatch.setattr(tb, "CG_CHECK_EVERY", 1)
    stats = tb.PGOStats()
    every = tb.optimize(tg, cfg, stats)
    assert torch.equal(chunked.poses, every.poses)
    assert stats.cg_launched == sum(stats.cg_iterations) + sum(
        n < cfg.cg_iterations for n in stats.cg_iterations)


def _ref_optimize(builder_poses, template, dtype, cfg):
    jg = template.to_device(dtype)
    return np.asarray(jb.optimize(jg._replace(poses=jnp.asarray(builder_poses)), cfg).poses)


def test_circle_optimization_matches_reference(circle):
    gt, drifted, rels = circle
    jbld, tbld = _builders(gt, drifted, rels)
    jg, tg = _graphs((jbld, tbld), "float32")
    cfg_j, cfg_t = jb.PGOConfig(max_iterations=15), tb.PGOConfig(max_iterations=15)
    ref = np.asarray(jb.optimize(jg, cfg_j).poses)
    # the reference's own spread: its input poses moved by one float32 ulp
    base = np.asarray(jg.poses)
    sens = 0.0
    for direction in (np.inf, -np.inf):
        nudged = np.where(base != 0, np.nextafter(base, np.float32(direction)), 0.0)
        moved = np.asarray(jb.optimize(jg._replace(poses=jnp.asarray(nudged, jnp.float32)),
                                       cfg_j).poses)
        sens = max(sens, float(np.abs(moved - ref).max()))
    stats = tb.PGOStats()
    out = tb.optimize(tg, cfg_t, stats)
    got = N(out.poses)
    gap = float(np.abs(got - ref).max())
    assert gap <= max(1e-4, 3.0 * sens), (gap, sens)
    # and the reference test's own bounds
    n = len(gt)
    assert float(tb.graph_cost(out)) < float(tb.graph_cost(tg))
    err_before = np.linalg.norm(drifted[:, :3, 3] - gt[:, :3, 3], axis=1)
    err_after = np.linalg.norm(got[:n, :3, 3] - gt[:, :3, 3], axis=1)
    assert err_after[-1] < 0.2 and err_after[-1] < err_before[-1] * 0.25
    assert err_after.mean() < err_before.mean() * 0.8
    assert 1 <= stats.gn_iterations <= 15 and max(stats.cg_iterations) <= 500


def test_anchor_stays_fixed(circle):
    gt, drifted, rels = circle
    jg, tg = _graphs(_builders(gt, drifted, rels), "float64")
    out = tb.optimize(tg, tb.PGOConfig(max_iterations=3, cg_iterations=60))
    np.testing.assert_allclose(N(out.poses[0]), drifted[0], atol=1e-9)
    ref = jb.optimize(jg, jb.PGOConfig(max_iterations=3, cg_iterations=60))
    np.testing.assert_allclose(N(out.poses), N(ref.poses), atol=1e-5)


def test_perfect_graph_is_stationary():
    gt = circle_poses(30)
    b = tb.PoseGraphBuilder(max_nodes=32, max_edges=64)
    for p in gt:
        b.add_node(p)
    for i in range(29):
        b.add_odometry_edge(i, np.linalg.inv(gt[i]) @ gt[i + 1])
    out = tb.optimize(b.to_device(torch.float64, device="cpu"),
                      tb.PGOConfig(max_iterations=5, cg_iterations=60))
    np.testing.assert_allclose(N(out.poses[:30]), gt, atol=1e-6)


def test_absolute_constraint_pins_node():
    gt = circle_poses(20)
    drifted, rels = drifted_odometry(gt, np.random.default_rng(1), noise_trans=0.1)
    outs = []
    for mod, kw in ((jb, {}), (tb, {"device": "cpu"})):
        b = mod.PoseGraphBuilder(max_nodes=32, max_edges=64)
        for p in drifted:
            b.add_node(p)
        for i, r in enumerate(rels):
            b.add_odometry_edge(i, r)
        b.add_edge(0, 19, np.linalg.inv(gt[0]) @ gt[19], np.full(6, 100.0))
        dtype = jnp.float64 if mod is jb else torch.float64
        outs.append(N(mod.optimize(b.to_device(dtype, **kw), mod.PGOConfig(max_iterations=15)).poses))
    np.testing.assert_allclose(outs[1][19, :3, 3], gt[19, :3, 3], atol=0.05)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)


def test_prior_residual_and_default_information():
    x = np.asarray(jse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, 0.0, -0.04])))
    b = tb.PoseGraphBuilder(max_nodes=4, max_edges=4, max_priors=4)
    b.add_node(x)
    b.add_absolute_edge(0, x)
    np.testing.assert_allclose(b.priors[0][2], tb.ABSOLUTE_INFO)
    g = b.to_device(torch.float64, device="cpu")
    np.testing.assert_allclose(N(g.prior_info[0]), [1.0, 1.0, 1.0, 0.001, 0.001, 0.001])
    np.testing.assert_allclose(N(tb.prior_residuals(g, g.poses))[0], 0.0, atol=1e-10)
    assert (tb.ODOMETRY_INFO, tb.LOOP_INFO, tb.ABSOLUTE_INFO) == (
        jb.ODOMETRY_INFO, jb.LOOP_INFO, jb.ABSOLUTE_INFO)


def test_edge_residual_definition():
    a = np.eye(4)
    bpose = np.asarray(jse3.exp(jnp.asarray([1.0, 0.5, 0.0, 0.0, 0.0, 0.3])))
    b = tb.PoseGraphBuilder(max_nodes=4, max_edges=4)
    b.add_node(a)
    b.add_node(bpose)
    b.add_edge(0, 1, np.linalg.inv(a) @ bpose)
    g = b.to_device(torch.float64, device="cpu")
    np.testing.assert_allclose(N(tb.edge_residuals(g, g.poses))[0], 0.0, atol=1e-10)


@pytest.mark.parametrize("which", ["nodes", "priors"])
def test_capacity_overflow_raises(which):
    for mod in (jb, tb):
        if which == "nodes":
            b = mod.PoseGraphBuilder(max_nodes=2, max_edges=2)
            for _ in range(3):
                b.add_node(np.eye(4))
        else:
            b = mod.PoseGraphBuilder(max_nodes=8, max_edges=8, max_priors=1)
            b.add_node(np.eye(4))
            b.add_absolute_edge(0, np.eye(4))
            b.add_absolute_edge(0, np.eye(4))
        with pytest.raises(ValueError, match="capacity"):
            b.to_device() if mod is jb else b.to_device(device="cpu")


def test_accumulation_is_the_references_index_add_order(circle):
    """One scatter-add of the active edge_i, edge_j and prior terms
    concatenated equals three ``index_add_`` over the whole capacity in that
    order (the reference's ``.at[idx].add``), to the bit: a padded slot's
    term is an exact zero."""
    gt, drifted, rels = circle
    _, tg = _graphs(_builders(gt, drifted, rels, priors=(5, 50)), "float32")
    rng = np.random.default_rng(4)
    e, p = int(tg.num_edges), int(tg.num_priors)
    cap_e, cap_p = tg.edge_i.shape[0], tg.prior_node.shape[0]
    assert (e, p) == (60, 2) and (cap_e, cap_p) == (128, 8)

    def terms(n, live):
        y = np.zeros((n, 6), np.float32)
        y[:live] = rng.normal(size=(live, 6))
        return torch.from_numpy(y)

    yi, yj, yp = terms(cap_e, e), terms(cap_e, e), terms(cap_p, p)
    acc = tb._Accumulator(tb._active_part(tg, e, p))
    assert acc.idx.shape == (1, 2 * e + p)
    got = acc(yi[:e], yj[:e], yp[:p])
    ref = torch.zeros(64, 6)
    ref.index_add_(0, tg.edge_i.long(), yi)
    ref.index_add_(0, tg.edge_j.long(), yj)
    ref.index_add_(0, tg.prior_node.long(), yp)
    assert torch.equal(got, ref)
    live = torch.cat([yi[:e], yj[:e], yp[:p]])[None]
    assert torch.equal(got, scatter_add_rows_plain(live, acc.idx, 64)[0])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.PoseGraphBuilder().to_device()
