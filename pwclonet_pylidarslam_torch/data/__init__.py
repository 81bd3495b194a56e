"""Data layer: dataset readers (KITTI, KITTI-360, NCLT, Ford Campus, NHCD,
PLY directories, KITTI-CARLA, rosbags and UrbanLoco), synthetic sequences,
the vertex-map pair and window datasets of PoseResNet training
(``vm_pairs.py``), the shape datasets of the PointNet++ cls/semseg family
(``shapes.py``), and the native scan loader with host-side prefetching
(``native_loader.py``)."""

from pwclonet_pylidarslam_torch.data.synthetic import (  # noqa: F401
    SyntheticSequenceConfig,
    generate_sequence,
)
from pwclonet_pylidarslam_torch.data.shapes import (  # noqa: F401
    Indoor3DSemSegDataset,
    ModelNet40Dataset,
    SyntheticRooms,
    SyntheticShapes,
)
