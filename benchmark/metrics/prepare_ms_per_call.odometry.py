"""prepare_ms_per_call.odometry: Host ms of the odometry's scan preparation a call: the program's odometry.prepare spans over its odometry.call spans, in the profiled stretch."""

from benchmark.harness import program_trace

program_trace.install()

UNIT = "ms"
LAYER = "odometry driver"
MOVES = "odometry_frames_per_s"
SOURCE = "program_span"


def read(rec):
    return program_trace.ms_per(rec, lambda s: s[0] == "odometry.prepare",
                                lambda p: p.calls("odometry.call"))
