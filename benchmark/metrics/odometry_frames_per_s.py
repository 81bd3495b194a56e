"""odometry_frames_per_s: Odometry throughput: the frames whose poses came back in the window over its elapsed time."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "frames/s"
SOURCE = "host_clock"


def read(rec):
    return readers.rate(rec)
