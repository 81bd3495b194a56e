"""Training of PWCLO-Net, of PoseResNet and of the PointNet++ cls/semseg
family: losses, train states and steps, trainers."""

from pwclonet_pylidarslam_torch.train.losses import (  # noqa: F401
    PWCLONetLossConfig,
    pwclonet_loss,
)
from pwclonet_pylidarslam_torch.train.cls_seg import (  # noqa: F401
    ClsSegTrainConfig,
    ClsSegTrainState,
    cls_seg_eval_step,
    cls_seg_train_step,
    create_cls_seg_state,
)
# the reference's PoseNetTrainState is the port's train/state.py::TrainState,
# which create_posenet_train_state returns
from pwclonet_pylidarslam_torch.train.posenet_state import (  # noqa: F401
    PoseNetTrainConfig,
    create_posenet_train_state,
    posenet_eval_step,
    posenet_train_step,
)
