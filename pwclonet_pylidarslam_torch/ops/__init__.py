"""Point-set ops (FPS, kNN, gather with its scatter-add backward) and the
fused eval-mode blocks (MLP + max-pool, attentive aggregate). Each launches
its CUDA kernel on CUDA tensors and runs its plain PyTorch version on CPU
tensors. The ball query is plain PyTorch on every device, as in the
reference; the three-NN interpolation runs on the kNN and gather kernels."""

from pwclonet_pylidarslam_torch.ops.ball_query import ball_query
from pwclonet_pylidarslam_torch.ops.costvolume import attentive_aggregate
from pwclonet_pylidarslam_torch.ops.fps import furthest_point_sample
from pwclonet_pylidarslam_torch.ops.gather import (
    ScatterPlan,
    gather_points,
    group_points,
    group_points_multi,
    scatter_add_rows,
)
from pwclonet_pylidarslam_torch.ops.interpolate import three_interpolate, three_nn
from pwclonet_pylidarslam_torch.ops.knn import knn
from pwclonet_pylidarslam_torch.ops.mlp import fold_bn, fold_stack, mlp_maxpool

__all__ = [
    "ScatterPlan",
    "attentive_aggregate",
    "ball_query",
    "fold_bn",
    "fold_stack",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "group_points_multi",
    "knn",
    "mlp_maxpool",
    "scatter_add_rows",
    "three_interpolate",
    "three_nn",
]
