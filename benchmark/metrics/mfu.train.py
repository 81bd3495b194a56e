"""mfu.train: The model FLOPs of the window's training steps (the forward three times over) over its elapsed time, in percent of 165 TFLOP/s (3xTF32)."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "%"
LAYER = "whole step, model"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(rec):
    return readers.mfu(rec)
