"""SLAM: classic ICP and PWCLO-Net deep odometry, loop closure, the
pose-graph back end, the pipeline and its runner. Exports what the
reference's ``slam/__init__.py`` exports, for the names that are ported."""

from pwclonet_pylidarslam_torch.slam.icp_odometry import (  # noqa: F401
    ICPConfig,
    ICPOdometry,
)
