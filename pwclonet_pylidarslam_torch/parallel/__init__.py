"""The parallel layer on ``torch.distributed``: device meshes, the process
bootstrap, data-parallel PWCLO-Net training, point-sharded ICP, the
row-sharded voxel map, the edge-sharded pose graph and the scaling harness.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/parallel/``, with its
public names. The reference's functions run under one controller over many
devices (``shard_map``, GSPMD); here each rank is a process with one device
(NCCL on CUDA, gloo on the CPU), every rank calls a sharded function with
the same global inputs, takes its share by its coordinate on a mesh axis,
and gets the reference's replicated outputs through all-reduces and
all-gathers on that axis's group. Every host-side branch that can end a
loop reads reduced values, so the ranks leave it together.

On one rank each sharded function is bit-equal to its unsharded
counterpart in the port, the data-parallel train step excepted (its
moments and gradients are summed in another order).
"""

from pwclonet_pylidarslam_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated,
)
from pwclonet_pylidarslam_torch.parallel.distributed import (  # noqa: F401
    initialize,
    local_batch_slice,
    host_local_devices,
    shutdown,
)
from pwclonet_pylidarslam_torch.parallel.data_parallel import (  # noqa: F401
    make_parallel_train_step,
    shard_batch,
    replicate_state,
)
from pwclonet_pylidarslam_torch.parallel.sharded_icp import (  # noqa: F401
    solve_point_to_plane_sharded,
    solve_point_to_point_sharded,
)
from pwclonet_pylidarslam_torch.parallel.sharded_map import (  # noqa: F401
    build_voxel_table_sharded,
    gather_voxel_table,
    voxel_nn_sharded,
)
from pwclonet_pylidarslam_torch.parallel.sharded_backend import optimize_sharded  # noqa: F401

# ``parallel.scaling`` (``ScalingConfig``, ``measure_scaling``, ``main``) is
# not imported here, as in the reference: it runs as ``python -m``.
