"""PWCLO-Net, the PointNet++ classifiers and segmenter (and, in
``models/posenet.py``, PoseResNet) in PyTorch, and the Flax weight and
train-state converter."""

from pwclonet_pylidarslam_torch.models.cls_seg import (
    CLS_MSG,
    CLS_SSG,
    SEM_SSG,
    PointNet2Classification,
    PointNet2Segmentation,
    SAStage,
)
from pwclonet_pylidarslam_torch.models.convert import load_flax_train_state, load_flax_variables
from pwclonet_pylidarslam_torch.models.pwclonet import (
    PWCLONet,
    PWCLONetConfig,
    params_to_pose_matrix,
    scaled_model_config,
)

__all__ = [
    "CLS_MSG",
    "CLS_SSG",
    "PointNet2Classification",
    "PointNet2Segmentation",
    "SAStage",
    "SEM_SSG",
    "PWCLONet",
    "PWCLONetConfig",
    "load_flax_train_state",
    "load_flax_variables",
    "params_to_pose_matrix",
    "scaled_model_config",
]
