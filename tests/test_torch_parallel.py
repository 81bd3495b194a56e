"""The parallel layer of the port (``pwclonet_pylidarslam_torch/parallel/``)
on the CPU with gloo, at world sizes 1 and 2.

World size 1 runs in this process, on a group of this process alone that a
fixture sets up and destroys; there every sharded function is held
``torch.equal`` to its unsharded counterpart in the port (an all-reduce over
one rank is the identity), and so is the data-parallel train step, whose
moments are each rank's ``var_mean`` combined over the ranks.

World size 2 runs once for the module in two spawned processes
(``tests/_torch_parallel_child.py``), which meet through a ``file://``
rendezvous under the test's temporary directory (no port to collide under
xdist), write their outputs to ``.npz`` files and are killed if they have
not finished within ``WORLD2_TIMEOUT_S``: a hung collective fails the tests
that read them, not the suite's time limit. The processes start when the
module does, and this process computes the references meanwhile. Their
outputs are held against the JAX reference's sharded functions on a
2-device mesh of the 8 virtual CPU devices, at ``tests/test_parallel.py``'s
tolerances: ICP pose atol 1e-6, cost rtol 1e-5, the true pose within 1e-4;
the voxel table bit-identical and the NN weights equal, targets and normals
within 1e-6; the pose graph in float64 within 5e-6 (cost rtol 1e-9). Batched
ICP over two ranks is held bit-equal to ``mesh=None`` (each sequence's step
rounds as it does alone at one torch thread), ``PointMLP`` in train mode to
one process on the whole batch (outputs, gradients and pending statistics
within 1e-5 of their scale: the moments are combined in another order), and
every replicated output equal on both ranks.
"""

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pwclonet_pylidarslam_torch import parallel as tpar
from pwclonet_pylidarslam_torch.core import optimization as topt
from pwclonet_pylidarslam_torch.data.synthetic import SyntheticSequenceConfig, generate_sequence
from pwclonet_pylidarslam_torch.models import PWCLONetConfig as TPWCLONetConfig
from pwclonet_pylidarslam_torch.models.layers import PointMLP
from pwclonet_pylidarslam_torch.slam import backend as tbackend
from pwclonet_pylidarslam_torch.slam import icp_odometry as ticp
from pwclonet_pylidarslam_torch.slam import local_map as tlm
from pwclonet_pylidarslam_torch.train import state as tstate
from pwclonet_pylidarslam_tpu import parallel as jpar
from pwclonet_pylidarslam_tpu.core import se3 as jse3
from pwclonet_pylidarslam_tpu.parallel.sharded_backend import optimize_sharded as j_optimize_sharded
from pwclonet_pylidarslam_tpu.slam import backend as jbackend

CHILD = Path(__file__).with_name("_torch_parallel_child.py")
REPO = Path(__file__).resolve().parents[1]
WORLD2_TIMEOUT_S = 120  # from the start of the two processes to their exit
# the slow tests whose work the two processes add when they are selected
EXTRAS = {"test_world2_data_parallel_step_meets_the_reference_bar": "train",
          "test_world2_scaling_harness": "scaling"}
TRAIN_CFG = tstate.TrainConfig(
    model=TPWCLONetConfig(num_points=128, sa_npoints=(32, 16, 8, 4), sa_nsamples=(8, 8, 4, 4)),
    total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops on one thread: with several test workers on one
    machine, torch's thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- inputs, made from seeds, float32 unless said ------------------------------------


def plane_world(seed: int, n: int = 512):
    """Points on random planes with their normals and a small SE(3) (the
    reference's ``tests/test_parallel.py::_plane_world``)."""
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    target = rng.normal(size=(n, 3)).astype(np.float64) * 5.0
    twist = np.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.015])
    true_pose = np.asarray(jse3.exp(jnp.asarray(twist)[None])[0])
    inv = np.linalg.inv(true_pose)
    source = target @ inv[:3, :3].T + inv[:3, 3]
    f32 = lambda a: a.astype(np.float32)[None]  # noqa: E731
    return f32(source), f32(target), f32(normals), true_pose


def voxel_world(m: int = 4096):
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((m, 3)) * 12.0).astype(np.float32)
    nrm = rng.standard_normal((m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = (rng.uniform(size=m) > 0.1).astype(np.float32)
    return pts, nrm, valid, (pts[:512] + 0.2).astype(np.float32)


@functools.lru_cache(maxsize=2)
def circle(gps: bool):
    """``tests/test_parallel.py``'s circle of 40 drifted poses: ground
    truth, the drifted chain and its relative poses."""
    from pgo_fixtures import circle_poses, drifted_odometry

    gt = circle_poses(40)
    if gps:
        return (gt,) + drifted_odometry(gt, np.random.default_rng(5), noise_trans=0.05)
    return (gt,) + drifted_odometry(gt, np.random.default_rng(3))


def circle_builder(builder_cls, info, gps: bool):
    """The circle with one loop edge (``gps``: two absolute priors instead,
    the reference's GPS case), in either implementation's
    ``PoseGraphBuilder``."""
    gt, drifted, rels = circle(gps)
    if gps:
        b = builder_cls(max_nodes=64, max_edges=64, max_priors=8)
    else:
        b = builder_cls(max_nodes=64, max_edges=64)
    for p in drifted:
        b.add_node(p)
    for i, r in enumerate(rels):
        b.add_odometry_edge(i, r)
    if gps:
        for i in (15, 39):
            b.add_absolute_edge(i, gt[i])
    else:
        b.edges.append((0, 39, np.linalg.inv(gt[0]) @ gt[39], np.asarray(info)))
    return gt, b


def port_graph(gps: bool, dtype=torch.float64):
    gt, b = circle_builder(tbackend.PoseGraphBuilder, tbackend.LOOP_INFO, gps)
    return gt, b.to_device(dtype, device="cpu")


def ref_graph(gps: bool):
    gt, b = circle_builder(jbackend.PoseGraphBuilder, jbackend.LOOP_INFO, gps)
    return gt, b.to_device(jnp.float64)


def two_sequences():
    """Two synthetic sequences (seeds 0, 1) of 4 frames at 1024 points."""
    return np.stack([
        generate_sequence(SyntheticSequenceConfig(n_frames=4, num_points=1024, seed=s,
                                                  speed=0.8), device="cpu")[0]
        for s in (0, 1)]).astype(np.float32)


def train_batch():
    """``tests/test_parallel.py::test_data_parallel_step_matches_single_device``'s batch."""
    rng = np.random.default_rng(0)
    return {
        "xyz1": (rng.normal(size=(8, 128, 3)).astype(np.float32) * 8),
        "xyz2": (rng.normal(size=(8, 128, 3)).astype(np.float32) * 8),
        "gt_params": np.tile(np.asarray([[0.1, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]], np.float32),
                             (8, 1)),
    }


def mlp_inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(8, 16, 6, 10)) * 3 + 1).astype(np.float32)
    return x, rng.normal(size=(8, 16, 32)).astype(np.float32)


def port_mlp():
    return PointMLP(10, (16, 32), generator=torch.Generator().manual_seed(0))


# --- the two-process group -------------------------------------------------------------


class World2:
    """Two ranks started together; :meth:`outputs` waits for both (at most
    until ``WORLD2_TIMEOUT_S`` after the start), kills them on overrun and
    fails, else returns each rank's outputs."""

    def __init__(self, work: Path, extras):
        inputs = work / "inputs.npz"
        icp = plane_world(3)
        p2p = plane_world(4)
        mask = np.ones((1, 512), np.float32)
        mask[:, -17:] = 0.0
        pts, nrm, valid, query = voxel_world()
        arrays = {"icp_source": icp[0], "icp_target": icp[1], "icp_normals": icp[2],
                  "icp_mask": mask, "p2p_source": p2p[0], "p2p_target": p2p[1],
                  "map_points": pts, "map_normals": nrm, "map_valid": valid, "map_query": query,
                  "seqs": two_sequences()}
        for name, gps in (("circle", False), ("gps", True)):
            graph = port_graph(gps)[1]
            arrays.update({f"{name}_{f}": getattr(graph, f).numpy() for f in graph._fields})
        arrays["mlp_x"], arrays["mlp_cot"] = mlp_inputs()
        arrays.update({f"train_{k}": v for k, v in train_batch().items()})
        np.savez(inputs, **arrays)
        self.work = work
        self.inputs = arrays
        self.start = time.monotonic()
        self.procs = []
        for rank in range(2):  # each rank's output to a file: no pipe to fill and block
            with open(work / f"rank{rank}.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(CHILD), str(work / "rendezvous"), str(rank), "2",
                     str(inputs), str(work), *extras],
                    cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                    env={**os.environ, "PYTHONPATH": str(REPO)}))
        self._outputs = None

    def outputs(self):
        if self._outputs is None:
            for p in self.procs:
                left = WORLD2_TIMEOUT_S - (time.monotonic() - self.start)
                try:
                    p.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"the two gloo ranks did not finish within {WORLD2_TIMEOUT_S} s")
            for rank, p in enumerate(self.procs):
                assert p.returncode == 0, (self.work / f"rank{rank}.log").read_text()[-3000:]
            self._outputs = [dict(np.load(self.work / f"out{r}.npz")) for r in range(2)]
        return self._outputs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def world2_group(request, tmp_path_factory):
    """The two ranks, started with the module (before its first test)."""
    here = Path(__file__).name
    extras = sorted({extra for item in request.session.items
                     if Path(str(item.fspath)).name == here
                     for name, extra in EXTRAS.items() if item.name == name})
    group = World2(tmp_path_factory.mktemp("world2"), extras)
    yield group
    group.kill()


@pytest.fixture
def world2(world2_group):
    return world2_group.outputs()


@pytest.fixture(scope="module")
def mesh1():
    """A mesh of this process alone on a group that it sets up, destroyed
    after the module."""
    started = not dist.is_initialized()
    mesh = tpar.make_mesh(device="cpu")
    yield mesh
    if started:
        tpar.shutdown()


def jmesh2():
    return jpar.make_mesh(n_data=2)


def T(x):
    return torch.from_numpy(np.array(x))


def assert_replicated(world2, *keys):
    for k in keys:
        np.testing.assert_array_equal(world2[0][k], world2[1][k], err_msg=k)


# --- bootstrap and meshes --------------------------------------------------------------


def test_initialize_refuses_cuda_without_a_card():
    """No fallback: CUDA asked for where there is none raises, and no group
    (gloo or other) is set up instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    before = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.initialize(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh(device="cuda")
    assert dist.is_initialized() == before


def test_world1_mesh_and_bootstrap(mesh1):
    assert mesh1.shape == (1, 1) and mesh1.mesh_dim_names == ("data", "model")
    assert tpar.make_mesh(n_data=1, n_model=1, device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(n_data=1, n_model=2, device="cpu")
    tpar.initialize(device="cpu")  # a second call is harmless
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tpar.local_batch_slice(8) == slice(0, 8)
    assert tpar.host_local_devices() == [torch.device("cpu")]
    assert tpar.batch_sharding(mesh1).place(np.arange(6)).tolist() == list(range(6))
    t = torch.arange(3.0)
    assert tpar.replicated(mesh1).place(t) is t


def test_world2_mesh_and_bootstrap(world2):
    for rank, out in enumerate(world2):
        assert out["mesh_shape"].tolist() == [2, 1]
        assert out["mesh_sub_shapes"].tolist() == [[1, 1], [1, 2]]
        assert out["refuse_mesh"]
        assert out["local_slice"].tolist() == [4 * rank, 4 * rank + 4]
        assert out["refuse_batch_slice"]
        assert out["devices"].tolist() == ["cpu"]


def test_world2_refuses_what_does_not_divide(world2):
    for out in world2:
        for what in ("icp", "backend", "batched", "train"):
            assert out[f"refuse_{what}"], what


# --- point-sharded ICP -----------------------------------------------------------------


def test_world1_sharded_icp_is_the_unsharded_solve(mesh1):
    src, tgt, nrm, true_pose = plane_world(3)
    src, tgt, nrm = T(src), T(tgt), T(nrm)
    mask = torch.ones(src.shape[:2])
    mask[:, -17:] = 0.0
    for ref, got in (
        (topt.solve_point_to_plane(src, tgt, nrm, mask=mask),
         tpar.solve_point_to_plane_sharded(src, tgt, nrm, mesh1, mask=mask)),
        (topt.solve_point_to_point(src, tgt), tpar.solve_point_to_point_sharded(src, tgt, mesh1)),
    ):
        for a, b in zip(ref, got):
            assert torch.equal(a, b)
        np.testing.assert_allclose(got.pose[0].numpy(), true_pose, atol=1e-4)


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_world2_sharded_icp_matches_the_reference(world2, kind):
    seed = 3 if kind == "plane" else 4
    src, tgt, nrm, true_pose = plane_world(seed)
    jm = jmesh2()
    if kind == "plane":
        mask = jnp.ones((1, 512), jnp.float32).at[:, -17:].set(0.0)
        ref = jax.jit(lambda s, t, n: jpar.solve_point_to_plane_sharded(s, t, n, jm, mask=mask))(
            src, tgt, nrm)
    else:
        ref = jax.jit(lambda s, t: jpar.solve_point_to_point_sharded(s, t, jm))(src, tgt)
    assert_replicated(world2, f"{kind}_pose", f"{kind}_cost")
    out = world2[0]
    np.testing.assert_allclose(out[f"{kind}_pose"], np.asarray(ref.pose), atol=1e-6)
    np.testing.assert_allclose(out[f"{kind}_cost"], np.asarray(ref.cost), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(out[f"{kind}_pose"][0], true_pose, atol=1e-4)


# --- row-sharded voxel map -------------------------------------------------------------


def test_world1_sharded_map_is_the_unsharded_map(mesh1):
    pts, nrm, valid, query = (T(x) for x in voxel_world())
    for nb, voxel in ((27, 0.8), (8, 1.6)):
        kw = dict(voxel_size=voxel, table_size=1 << 12, bucket_cap=8)
        ref = tlm.build_voxel_table(pts, nrm, valid, **kw)
        table = tpar.build_voxel_table_sharded(pts, nrm, valid, mesh=mesh1, **kw)
        for a, b in zip(ref, tpar.gather_voxel_table(table, mesh1)):
            assert torch.equal(a, b)
        for a, b in zip(tlm.voxel_nn(ref, query, voxel, 0.8, neighborhood=nb),
                        tpar.voxel_nn_sharded(table, query, voxel, 0.8, mesh1, neighborhood=nb)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("neighborhood", [27, 8])
def test_world2_sharded_map_matches_the_reference(world2, neighborhood):
    from pwclonet_pylidarslam_tpu.parallel.sharded_map import (
        build_voxel_table_sharded,
        voxel_nn_sharded,
    )

    voxel = 1.6 if neighborhood == 8 else 0.8
    jm = jmesh2()

    def build_and_query(pts, nrm, valid, query):
        table = build_voxel_table_sharded(pts, nrm, valid, voxel_size=voxel, mesh=jm,
                                          table_size=1 << 12, bucket_cap=8)
        return table, voxel_nn_sharded(table, query, voxel, max_distance=0.8, mesh=jm,
                                       neighborhood=neighborhood)

    # jitted: the same result as called eagerly, compiled once instead of op by op
    table, nn = jax.jit(build_and_query)(*voxel_world())
    t_ref, n_ref, w_ref = (np.asarray(x) for x in nn)
    keys = [f"table{neighborhood}_points", f"table{neighborhood}_normals",
            f"nn{neighborhood}_target", f"nn{neighborhood}_normal", f"nn{neighborhood}_weight"]
    assert_replicated(world2, *keys)
    out = world2[0]
    np.testing.assert_array_equal(out[keys[0]], np.asarray(table.points))
    np.testing.assert_array_equal(out[keys[1]], np.asarray(table.normals))
    np.testing.assert_array_equal(out[keys[4]], w_ref)
    ok = w_ref > 0
    assert ok.sum() > 0
    np.testing.assert_allclose(out[keys[2]][ok], t_ref[ok], atol=1e-6)
    np.testing.assert_allclose(out[keys[3]][ok], n_ref[ok], atol=1e-6)


# --- edge-sharded pose graph -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_world1_sharded_backend_is_optimize(mesh1, dtype):
    cfg = tbackend.PGOConfig(max_iterations=10)
    graph = port_graph(gps=dtype == torch.float32, dtype=dtype)[1]
    stats_a, stats_b = tbackend.PGOStats(), tbackend.PGOStats()
    ref = tbackend.optimize(graph, cfg, stats_a)
    got = tpar.optimize_sharded(graph, mesh1, cfg, stats=stats_b)
    assert torch.equal(ref.poses, got.poses)
    assert stats_a.cg_iterations == stats_b.cg_iterations


@pytest.mark.parametrize("gps", [False, True], ids=["loop", "gps_priors"])
def test_world2_sharded_backend_matches_the_reference(world2, gps):
    name = "gps" if gps else "circle"
    gt, graph = ref_graph(gps)
    jm = jmesh2()
    ref = jax.jit(lambda g: j_optimize_sharded(g, jm, jbackend.PGOConfig(max_iterations=10)))(
        graph)
    assert_replicated(world2, f"{name}_poses", f"{name}_cost")
    poses = world2[0][f"{name}_poses"]
    np.testing.assert_allclose(poses, np.asarray(ref.poses), atol=5e-6)
    np.testing.assert_allclose(world2[0][f"{name}_cost"],
                               float(jax.jit(jbackend.graph_cost)(ref)), rtol=1e-9)
    if gps:  # the priors pulled the trajectory toward the fixes
        assert np.linalg.norm(poses[39, :3, 3] - gt[39, :3, 3]) < 0.35


# --- batched ICP over the sequence axis ------------------------------------------------


def _batched(seqs, mesh=None):
    odo = ticp.BatchedICPOdometry(ticp.ICPConfig(num_points=seqs.shape[2]), device="cpu",
                                  mesh=mesh)
    odo.init(seqs.shape[0])
    poses = odo.process_chunk(seqs)
    np.testing.assert_array_equal(odo.absolute_poses(), poses)
    return poses


@pytest.fixture(scope="module")
def batched_single(world2_group):
    return _batched(world2_group.inputs["seqs"])


def test_world1_batched_icp_mesh_is_mesh_none(mesh1, world2_group, batched_single):
    np.testing.assert_array_equal(_batched(world2_group.inputs["seqs"], mesh1), batched_single)


def test_world2_batched_icp_matches_mesh_none(world2, batched_single):
    assert_replicated(world2, "batched_poses")
    np.testing.assert_array_equal(world2[0]["batched_poses"], batched_single)


# --- data-parallel training ------------------------------------------------------------


def test_world2_point_mlp_train_mode_is_one_process_on_the_batch(world2):
    x, cot = mlp_inputs()
    mlp = port_mlp()
    xt = T(x).requires_grad_(True)
    y = mlp(xt, train=True, bn_momentum=0.5, maxpool=True)
    (y * T(cot)).sum().backward()
    got_y = np.concatenate([out["mlp_y"] for out in world2])
    got_dx = np.concatenate([out["mlp_dx"] for out in world2])

    def close(got, ref, what):
        ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=what)

    close(got_y, y, "output")
    close(got_dx, xt.grad, "input gradient")
    for name, p in mlp.named_parameters():
        assert_replicated(world2, f"mlp_grad_{name}")
        close(world2[0][f"mlp_grad_{name}"], p.grad, name)
    for name, v in mlp.pending.items():
        assert_replicated(world2, f"mlp_pending_{name}")
        close(world2[0][f"mlp_pending_{name}"], v, name)


def _flat_params(state):
    return torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])


def test_world1_data_parallel_step_is_train_step(mesh1):
    """At world size 1 the data-parallel step is ``train_step`` bit for bit
    (each rank's ``var_mean``, one rank's: the same moments; the dropout
    masks of the whole batch; an all-reduce over one rank), so it meets the
    reference's bar (loss rtol 1e-4, parameters 1e-4 at the 99.9th
    percentile and 1e-2 at most) with room."""
    batch = train_batch()
    single = tstate.create_train_state(TRAIN_CFG, 0, device="cpu")
    log1 = tstate.train_step(TRAIN_CFG, single, batch)
    state = tpar.replicate_state(tstate.create_train_state(TRAIN_CFG, 0, device="cpu"), mesh1)
    step = tpar.make_parallel_train_step(TRAIN_CFG, mesh1)
    log = step(state, tpar.shard_batch(batch, mesh1))
    assert set(log) == set(log1)
    for k in log1:
        assert torch.equal(log[k], log1[k]), k
    assert torch.equal(_flat_params(state), _flat_params(single))
    for a, b in zip(state.model.buffers(), single.model.buffers()):
        assert torch.equal(a, b)
    assert torch.equal(state.generator.get_state(), single.generator.get_state())


@pytest.mark.slow
def test_world2_data_parallel_step_meets_the_reference_bar(world2):
    """``tests/test_parallel.py::test_data_parallel_step_matches_single_device``'s
    bar, the two-rank step against ``train_step`` on the whole batch."""
    single = tstate.create_train_state(TRAIN_CFG, 0, device="cpu")
    log1 = tstate.train_step(TRAIN_CFG, single, train_batch())
    assert_replicated(world2, "train_loss", "train_params", "train_stats", "train_grad_norm")
    np.testing.assert_allclose(world2[0]["train_loss"], float(log1["loss"]), rtol=1e-4)
    diffs = np.abs(world2[0]["train_params"] - _flat_params(single).numpy())
    assert np.quantile(diffs, 0.999) < 1e-4
    assert diffs.max() < 1e-2


@pytest.mark.slow
def test_world2_scaling_harness(world2, world2_group):
    records = json.loads(str(world2[0]["scaling_records"]))
    assert [r["devices"] for r in records] == [1, 2]
    assert records[0]["efficiency"] == 1.0
    assert all(r["pairs_per_s"] > 0 for r in records)
    data = json.loads((world2_group.work / "scaling.json").read_text())
    assert data["platform"] == "cpu" and data["n_devices"] == 2
    assert [r["devices"] for r in data["records"]] == [1, 2]
    assert set(data["records"][0]) == {"devices", "batch", "ms_per_step", "pairs_per_s",
                                       "efficiency"}
    assert data["summary"]["metric"] == "dp_scaling_efficiency"
