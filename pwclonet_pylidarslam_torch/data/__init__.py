"""Synthetic LiDAR sequences (numpy), KITTI readers, and the vertex-map pair
and window datasets of PoseResNet training (``vm_pairs.py``)."""
