"""fused_ops_roofline.odometry: The stretch's fused MLP + max-pool and attentive aggregate bound (3xTF32 operations or bytes), counted from the configuration's shapes, over the device time of the operations launched inside the program's op.mlp_maxpool and op.attentive_aggregate spans."""

from benchmark.harness import program_trace, work

program_trace.install()

UNIT = "%"
LAYER = "fused blocks"
MOVES = "odometry_frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return program_trace.roofline(rec, program_trace.FUSED_OPS, work.fused_bound_total_s)
