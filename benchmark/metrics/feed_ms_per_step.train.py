"""feed_ms_per_step.train: Host ms of the input pipeline a step: the program's outermost data.* spans (pairs or items, their filter and augmentation, the batch's stack) over its train.steps counter, in the profiled stretch."""

from benchmark.harness import program_trace

program_trace.install()

UNIT = "ms"
LAYER = "data"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec):
    return program_trace.ms_per(rec, lambda s: s[0].startswith("data."),
                                lambda p: p.counters.get("train.steps", 0), outermost=True)
