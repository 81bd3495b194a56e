"""SLAM front-ends: PWCLO-Net deep odometry."""
