"""PWCLO-Net (and, in ``models/posenet.py``, PoseResNet) in PyTorch, and the
Flax weight and train-state converter."""

from pwclonet_pylidarslam_torch.models.convert import load_flax_train_state, load_flax_variables
from pwclonet_pylidarslam_torch.models.pwclonet import (
    PWCLONet,
    PWCLONetConfig,
    params_to_pose_matrix,
    scaled_model_config,
)

__all__ = [
    "PWCLONet",
    "PWCLONetConfig",
    "load_flax_train_state",
    "load_flax_variables",
    "params_to_pose_matrix",
    "scaled_model_config",
]
