"""odometry_latency_p95_ms: The 95th percentile of the wall time of every call into the odometry in the window."""

import numpy as np  # noqa: F401
from benchmark.harness import readers, work  # noqa: F401

UNIT = "ms"
SOURCE = "host_clock"


def read(rec):
    return 1e3 * float(np.percentile(rec.window.call_s, 95)) if rec.window.call_s else None
