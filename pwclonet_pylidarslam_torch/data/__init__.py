"""Synthetic LiDAR sequences (numpy), KITTI readers, the vertex-map pair
and window datasets of PoseResNet training (``vm_pairs.py``), and the shape
datasets of the PointNet++ cls/semseg family (``shapes.py``)."""
