"""launches_per_chunk.odometry: CUDA kernels a call into the odometry, counted in the profiled stretch."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "launches"
LAYER = "odometry driver"
MOVES = "odometry_frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return readers.launches_per_call(rec)
