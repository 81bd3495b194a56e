"""feed_idle.train: Device idle time while the host builds batches (gaps that went to a data.* span of the program), in percent of the profiled stretch's wall time."""

from benchmark.harness import program_trace

program_trace.install()

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec):
    return program_trace.idle_share(rec, lambda name: name.startswith("data."))
