"""launches_per_step.train: CUDA kernels a training step, counted in the profiled stretch."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "launches"
LAYER = "trainer, train step"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec):
    return readers.launches_per_step(rec)
