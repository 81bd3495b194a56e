"""Point-set ops: FPS, kNN and gather. Each launches its CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors."""

from pwclonet_pylidarslam_torch.ops.fps import furthest_point_sample
from pwclonet_pylidarslam_torch.ops.gather import gather_points, group_points, group_points_multi
from pwclonet_pylidarslam_torch.ops.knn import knn

__all__ = [
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "group_points_multi",
    "knn",
]
