"""KITTI odometry metrics (numpy)."""
