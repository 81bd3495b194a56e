"""point_ops_roofline.train: The stretch's FPS, kNN, gather and scatter-add bound, counted from the configuration's shapes, over the device time of the operations launched inside the program's op.fps, op.knn, op.gather, op.scatter_plan and op.scatter_sum spans."""

from benchmark.harness import program_trace, work

program_trace.install()

UNIT = "%"
LAYER = "point ops"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec):
    return program_trace.roofline(rec, program_trace.POINT_OPS, work.point_bound_s)
