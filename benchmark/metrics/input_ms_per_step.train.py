"""input_ms_per_step.train: Host time of the input pipeline a step: the harness's span around each next() of the batch iterator it hands the trainer, over the window."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "ms"
LAYER = "data"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(rec):
    c = rec.counters
    return 1e3 * c["input_s"] / c["input_steps"] if c.get("input_steps") else None
