"""SLAM: classic and continuous-time ICP, PWCLO-Net and PoseResNet deep
odometry, loop closure, the pose-graph back end, the pipeline and its
runner. Exports what the reference's ``slam/__init__.py`` exports, for the
names that are ported."""

from pwclonet_pylidarslam_torch.slam.ct_icp_odometry import (  # noqa: F401
    CTICPConfig,
    CTICPOdometry,
)
from pwclonet_pylidarslam_torch.slam.icp_odometry import (  # noqa: F401
    ICPConfig,
    ICPOdometry,
)
