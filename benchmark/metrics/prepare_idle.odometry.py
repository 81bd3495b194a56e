"""prepare_idle.odometry: Device idle time while the host prepares scans (gaps that went to the program's odometry.prepare span or one inside it), in percent of the profiled stretch's wall time."""

from benchmark.harness import program_trace

program_trace.install()

UNIT = "%"
LAYER = "device"
MOVES = "odometry_frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return program_trace.idle_share(rec, lambda name: name == "odometry.prepare")
