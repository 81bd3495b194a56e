"""device_idle.odometry: One minus the union of device operations over the profiled stretch's wall time."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "%"
LAYER = "device"
MOVES = "odometry_frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return readers.idle(rec)
