"""fused_kernels_roofline.odometry: The stretch's fused MLP + max-pool and attentive aggregate bound (3xTF32 operations or bytes), counted from the configuration's shapes, over the device time of those two kernels."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "%"
LAYER = "fused blocks"
MOVES = "odometry_frames_per_s"
SOURCE = "device_trace"
PATTERNS = [readers.PROGRAM_KERNEL + r"(mlp_maxpool|attentive_aggregate)_kernel\b"]


def read(rec):
    return readers.roofline(rec, PATTERNS, work.fused_bound_total_s)
