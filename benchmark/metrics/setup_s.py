"""setup_s: Set-up: process start to the first timed call, the kernel library's load or build included."""

from benchmark.harness import readers, work  # noqa: F401

UNIT = "s"
SOURCE = "host_clock"


def read(rec):
    return rec.setup_s
