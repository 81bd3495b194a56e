"""point_kernels_roofline.train: The stretch's FPS, kNN, gather and scatter-add bound, counted from the configuration's shapes, over the device time of those kernels."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "%"
LAYER = "point ops"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = [readers.PROGRAM_KERNEL + r"(fps|knn|gather)_kernel\b",
            readers.PROGRAM_KERNEL + r"scatter_(rank|scan|fill|sum)_kernel\b"]


def read(rec):
    return readers.roofline(rec, PATTERNS, work.point_bound_s)
