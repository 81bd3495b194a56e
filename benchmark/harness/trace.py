"""A profiled stretch of a run, reduced to what the per-layer metrics read.

``torch.profiler`` records the CUDA activity (device operations and the
host's CUDA runtime calls) over a few calls of the timed path; nothing is
written to disk. Host activity of the operators is not recorded: on the
PWCLO-Net train step it doubled the stretch's wall time, where the CUDA
activity alone adds about a quarter. The harness's own spans (``bench.*``)
are kept by the host clock on the profiler's time base (nanoseconds since
the epoch). The events are reduced at once to: each device operation's
name, start and end (kernels, copies, sets); the busy time (the union of
their intervals); the stretch's wall time; the device time by operation
name; and the idle gaps, each named by what the host was doing at its
middle (the innermost harness span, and the CUDA runtime call under way
there, or ``python`` where none was).
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Pattern, Tuple

import torch


@dataclass
class Stretch:
    """What a profiled stretch left: device events ``(name, start_s, end_s)``
    relative to the stretch's start, its wall time, the calls and units it
    held, and the idle time by host activity."""

    device_ops: List[Tuple[str, float, float]]
    window_s: float
    calls: int
    units: int
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def kernel_count(self) -> int:
        return sum(1 for name, _, _ in self.device_ops if not _is_memory_op(name))

    def time_matching(self, pattern: Pattern) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        return sum(e - s for name, s, e in self.device_ops if pattern.search(name))

    def top_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            by_name[name[:NAME_CHARS]] += e - s
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in
                sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]]


def _is_memory_op(name: str) -> bool:
    return name.lower().startswith(("memcpy", "memset"))


def _events(prof):
    """``(name, is_device, start_ns, end_ns)`` of every event, from the raw
    Kineto results (fast), or the profiler's function events."""
    from torch.autograd import DeviceType

    out = []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for ev in kineto.events():
            start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
            dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
            out.append((ev.name(), ev.device_type() == DeviceType.CUDA, start, start + dur))
        return out
    for ev in prof.events():
        out.append((ev.name, ev.device_type == DeviceType.CUDA,
                    int(ev.time_range.start * 1000), int(ev.time_range.end * 1000)))
    return out


class Spans:
    """The harness's host spans ``(name, start_ns, end_ns)``, by the epoch
    clock the profiler's events carry."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def profile(run: Callable[[Spans], Tuple[int, int]], device: torch.device) -> Stretch:
    """Profile ``run(spans)``, which makes some calls of the timed path and
    returns ``(calls, work units)``; the stretch's wall time is taken by the
    host clock between two synchronisations."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    spans = Spans()
    with torch_profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        _sync(device)
        origin = time.time_ns()
        calls, units = run(spans)
        _sync(device)
        end = time.time_ns()
    events = _events(prof)
    host = [(n, s, e) for n, dev, s, e in events if not dev and e > s]
    device_ops = [(n, max(s, origin), min(e, end)) for n, dev, s, e in events
                  if dev and e > s and e > origin and s < end]
    idle = _idle_by_host(device_ops, host + spans.spans, origin, end)
    return Stretch(device_ops=[(n, (s - origin) * 1e-9, (e - origin) * 1e-9)
                               for n, s, e in device_ops],
                   window_s=(end - origin) * 1e-9, calls=calls, units=units,
                   idle_by_host=idle)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _idle_by_host(device_ops, host, origin: int, end: int) -> Dict[str, float]:
    """Seconds of device idle time, summed by what the host was doing at the
    middle of each gap."""
    intervals = sorted((s, e) for _, s, e in device_ops)
    gaps, cursor = [], origin
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((cursor, end))
    if not gaps:
        return {}
    bench_spans = sorted((s, e, n) for n, s, e in host if n.startswith("bench."))
    # the CUDA runtime's calls do not nest: the last one started before the
    # middle covers it, or none does
    others = sorted((s, e, n) for n, s, e in host if not n.startswith("bench."))
    starts = [s for s, _, _ in others]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            out[f"gaps under {SHORT_GAP_NS // 1000} us"] += (g1 - g0) * 1e-9
            continue
        mid = (g0 + g1) // 2
        bench = next((n for s, e, n in reversed(bench_spans) if s <= mid <= e), None)
        i = bisect.bisect_right(starts, mid) - 1
        other = others[i][2] if i >= 0 and others[i][1] >= mid else "python"
        name = "/".join(x for x in (bench, other) if x)
        out[name] += (g1 - g0) * 1e-9
    return dict(out)


# a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160
# gaps shorter than this are the launch rhythm, summed apart
SHORT_GAP_NS = 20_000


def compile_patterns(patterns: List[str]) -> Pattern:
    return re.compile("|".join(f"(?:{p})" for p in patterns))
