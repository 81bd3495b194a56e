"""One rank of the two-process gloo group of ``tests/test_torch_parallel.py``.

``python tests/_torch_parallel_child.py INIT_FILE RANK WORLD INPUTS OUT_DIR
[EXTRA ...]``: joins the group through ``parallel.distributed.initialize``
(``file://`` rendezvous, no port), runs every sharded function of the port
on the global inputs of ``INPUTS`` (``.npz``, written by the test), and
writes this rank's outputs to ``OUT_DIR/out<RANK>.npz``. ``EXTRA``:
``train`` (the data-parallel train step at 128 points), ``scaling`` (the
scaling harness and its CLI). Imports torch and the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def refuses(fn) -> bool:
    """Whether ``fn()`` raises a ``ValueError`` that says "divisible"."""
    try:
        fn()
    except ValueError as e:
        return "divisible" in str(e)
    return False


def as_graph(data, prefix: str):
    from pwclonet_pylidarslam_torch.slam.backend import PoseGraph

    return PoseGraph(*(torch.from_numpy(data[f"{prefix}_{f}"]) for f in PoseGraph._fields))


def main(init_file: str, rank: int, world: int, inputs: str, out_dir: str, extras):
    torch.set_num_threads(1)
    from pwclonet_pylidarslam_torch import parallel as par
    from pwclonet_pylidarslam_torch.models.layers import PointMLP, sharded_batch
    from pwclonet_pylidarslam_torch.parallel.mesh import mesh_axis
    from pwclonet_pylidarslam_torch.slam import backend
    from pwclonet_pylidarslam_torch.slam import icp_odometry as icp

    par.initialize(init_method=f"file://{init_file}", world_size=world, rank=rank, device="cpu")
    data = np.load(inputs)
    t = {k: torch.from_numpy(data[k]) for k in data.files}
    out = {}

    # bootstrap and meshes
    sl = par.local_batch_slice(8)
    out["local_slice"] = np.asarray([sl.start, sl.stop])
    try:
        par.local_batch_slice(7)
        out["refuse_batch_slice"] = np.asarray(False)
    except ValueError:
        out["refuse_batch_slice"] = np.asarray(True)
    mesh = par.make_mesh(device="cpu")
    out["mesh_shape"] = np.asarray(mesh.shape)
    out["mesh_sub_shapes"] = np.asarray([par.make_mesh(n_data=1, device="cpu").shape,
                                         par.make_mesh(n_data=1, n_model=2, device="cpu").shape])
    try:
        par.make_mesh(n_data=3, device="cpu")
        out["refuse_mesh"] = np.asarray(False)
    except ValueError as e:
        out["refuse_mesh"] = np.asarray("devices" in str(e))
    out["devices"] = np.asarray([str(d) for d in par.host_local_devices()])

    # point-sharded ICP
    r = par.solve_point_to_plane_sharded(t["icp_source"], t["icp_target"], t["icp_normals"],
                                         mesh, mask=t["icp_mask"])
    out["plane_pose"], out["plane_cost"] = r.pose.numpy(), r.cost.numpy()
    r = par.solve_point_to_point_sharded(t["p2p_source"], t["p2p_target"], mesh)
    out["point_pose"], out["point_cost"] = r.pose.numpy(), r.cost.numpy()
    x = torch.zeros((1, 101, 3))
    out["refuse_icp"] = np.asarray(refuses(lambda: par.solve_point_to_plane_sharded(x, x, x,
                                                                                     mesh)))

    # row-sharded voxel map
    for nb, voxel in ((27, 0.8), (8, 1.6)):
        kw = dict(voxel_size=voxel, table_size=1 << 12, bucket_cap=8)
        table = par.build_voxel_table_sharded(t["map_points"], t["map_normals"], t["map_valid"],
                                              mesh=mesh, **kw)
        whole = par.gather_voxel_table(table, mesh)
        out[f"table{nb}_points"], out[f"table{nb}_normals"] = whole.points.numpy(), \
            whole.normals.numpy()
        tgt, nrm, w = par.voxel_nn_sharded(table, t["map_query"], voxel, max_distance=0.8,
                                           mesh=mesh, neighborhood=nb)
        out[f"nn{nb}_target"], out[f"nn{nb}_normal"], out[f"nn{nb}_weight"] = \
            tgt.numpy(), nrm.numpy(), w.numpy()

    # edge-sharded pose graph
    cfg = backend.PGOConfig(max_iterations=10)
    for name in ("circle", "gps"):
        g = par.optimize_sharded(as_graph(data, name), mesh, cfg)
        out[f"{name}_poses"] = g.poses.numpy()
        out[f"{name}_cost"] = backend.graph_cost(g).numpy()
    odd = backend.empty_graph(8, 63, 8, dtype=torch.float64, device="cpu")
    out["refuse_backend"] = np.asarray(refuses(lambda: par.optimize_sharded(odd, mesh, cfg)))

    # batched ICP over the sequence axis
    odo = icp.BatchedICPOdometry(icp.ICPConfig(num_points=data["seqs"].shape[2]), device="cpu",
                                 mesh=mesh)
    out["refuse_batched"] = np.asarray(refuses(lambda: odo.init(3)))
    odo.init(data["seqs"].shape[0])
    out["batched_poses"] = odo.process_chunk(data["seqs"])

    # PointMLP in train mode on this rank's rows, against one process on the batch
    ax = mesh_axis(mesh)
    mlp = PointMLP(t["mlp_x"].shape[-1], (16, 32), generator=torch.Generator().manual_seed(0))
    b = t["mlp_x"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    x = t["mlp_x"][rows].clone().requires_grad_(True)
    with sharded_batch(mlp, ax):
        y = mlp(x, train=True, bn_momentum=0.5, maxpool=True)
    (y * t["mlp_cot"][rows]).sum().backward()
    out["mlp_y"], out["mlp_dx"] = y.detach().numpy(), x.grad.numpy()
    for name, p in mlp.named_parameters():
        dist.all_reduce(p.grad, group=ax.group)
        out[f"mlp_grad_{name}"] = p.grad.numpy()
    for name, v in mlp.pending.items():
        out[f"mlp_pending_{name}"] = v.numpy()

    # the data-parallel train step's refusal of a batch that does not divide
    from pwclonet_pylidarslam_torch.models import PWCLONetConfig
    from pwclonet_pylidarslam_torch.train import state as ts

    tcfg = ts.TrainConfig(model=PWCLONetConfig(num_points=128, sa_npoints=(32, 16, 8, 4),
                                               sa_nsamples=(8, 8, 4, 4)), total_steps=10)
    step = par.make_parallel_train_step(tcfg, mesh)
    if "train" in extras:
        state = par.replicate_state(ts.create_train_state(tcfg, 0, device="cpu"), mesh)
        log = step(state, {k: data[f"train_{k}"] for k in ("xyz1", "xyz2", "gt_params")})
        out["train_loss"] = log["loss"].numpy()
        out["train_grad_norm"] = log["grad_norm"].numpy()
        out["train_params"] = torch.cat(
            [p.detach().reshape(-1) for p in state.model.parameters()]).numpy()
        out["train_stats"] = torch.cat(
            [b.reshape(-1) for b in state.model.buffers()]).numpy()
    odd_batch = {k: np.zeros((3,) + data[f"train_{k}"].shape[1:], np.float32)
                 for k in ("xyz1", "xyz2", "gt_params")}
    state = ts.create_train_state(tcfg, 0, device="cpu")
    out["refuse_train"] = np.asarray(refuses(lambda: step(state, odd_batch)))

    if "scaling" in extras:
        from pwclonet_pylidarslam_torch.parallel import scaling

        records = scaling.measure_scaling(scaling.ScalingConfig(
            tiny=True, batch_per_device=2, steps=2, warmup_steps=1, sizes=(1, 2), device="cpu"))
        out["scaling_records"] = np.asarray(json.dumps(records))
        scaling.main(["--tiny", "--sizes", "1,2", "--steps", "2", "--batch-per-device", "2",
                      "--device", "cpu", "--out", str(Path(out_dir, "scaling.json"))])

    np.savez(Path(out_dir, f"out{rank}.npz"), **out)
    dist.barrier()
    par.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
         sys.argv[6:])
