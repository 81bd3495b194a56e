"""train_samples_per_s: Training throughput: the samples of every step completed in the window over its elapsed time."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "samples/s"
SOURCE = "host_clock"


def read(rec):
    return readers.rate(rec)
