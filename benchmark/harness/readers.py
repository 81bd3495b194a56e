"""Readers that several metric files share; each metric file names its own
unit, layer, the end-to-end metric it moves and, where it reads kernel
time, the patterns of the kernel names it sums."""

from __future__ import annotations

from typing import List, Optional

from benchmark.harness import peaks, trace, work

# a kernel of the program's csrc/, outside any library namespace
PROGRAM_KERNEL = r"(?:^|\s|\(anonymous namespace\)::)"


def rate(rec) -> Optional[float]:
    """Units completed in the window over its elapsed time."""
    w = rec.window
    return w.units / w.elapsed_s if w.elapsed_s > 0 else None


def mfu(rec) -> Optional[float]:
    """The model FLOPs of the window's work over its elapsed time, in percent
    of the card's float32-accurate matrix peak (3xTF32)."""
    w = rec.window
    if w.elapsed_s <= 0:
        return None
    flops = work.model_flops(rec.work, rec.train) * w.work_units
    return 100.0 * flops / w.elapsed_s / peaks.FP32_ACCURATE_MATMUL_FLOPS


def roofline(rec, patterns: List[str], bound_of) -> Optional[float]:
    """The stretch's bound (``bound_of(work of one unit)`` times its units)
    over the device time of the kernels matching ``patterns``; None where
    nothing matched."""
    s = rec.stretch
    if s is None:
        return None
    spent = s.time_matching(trace.compile_patterns(patterns))
    return work.share(bound_of(rec.work) * s.units, spent)


def idle(rec) -> Optional[float]:
    s = rec.stretch
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def launches_per_step(rec) -> Optional[float]:
    s = rec.stretch
    if s is None or not s.units:
        return None
    return s.kernel_count() / (s.units / rec.batch)


def launches_per_call(rec) -> Optional[float]:
    s = rec.stretch
    if s is None or not s.calls:
        return None
    return s.kernel_count() / s.calls
