"""dispatch_ms_per_step.train: Host ms a training step spends issuing its device work: the program's train.forward, train.backward and train.optimizer spans on the stepping thread over its train.steps counter, in the profiled stretch."""

from benchmark.harness import program_trace

program_trace.install()

UNIT = "ms"
LAYER = "trainer, train step"
MOVES = "train_samples_per_s"
SOURCE = "program_span"
STEP = ("train.forward", "train.backward", "train.optimizer")


def read(rec):
    p = program_trace.of(rec)
    if p is None:
        return None
    return program_trace.ms_per(rec, lambda s: s[0] in STEP and s[2] == p.thread,
                                lambda p: p.counters.get("train.steps", 0))
