"""The program's own spans and counters in a profiled stretch.

The program names its layer boundaries with spans (``layer.what``, as
``odometry.prepare`` or ``op.knn``) and counts work at them, while a
recording of ``pwclonet_pylidarslam_torch/utils/timer.py`` is on; each span
is ``(name, parent, thread, start_ns, end_ns)`` on the epoch clock the
profiler's events carry. Here the recording is on for the profiled stretch
of a ``--trace 1`` run only, and each CUDA event keeps its correlation id and
thread, so that the stretch's time is reduced by program span:

- device time: each device operation goes to the innermost span open on the
  thread that made its correlated runtime call, at the call's start; where
  that thread has none open, to the recording thread's innermost span then
  (the autograd engine's device thread runs a backward on behalf of the
  caller's ``autograd.grad``); to none where neither has one;
- idle time: each gap of ``trace.SHORT_GAP_NS`` or more goes to the
  innermost span open at its middle on the thread that made the last runtime
  call before it, else on the recording thread. The gap's name in the
  breakdown becomes ``<harness span>/<program span>/<runtime call or
  python>``; a gap outside any program span keeps the harness's name.

The harness's own profile and run (``trace.profile``, ``runner.run_cell``)
read kernel names and the CUDA runtime's calls alone, so :func:`install`,
which each metric file that reads the spans calls when it is loaded, wraps
both: the profile of a stretch records the program's spans, and the
result's breakdown gains ``device_by_span`` (the top spans by device
seconds) and ``counters``. A program without the recorder gets the
harness's own profile untouched, and the metrics that read the spans read
nothing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.harness import runner, trace, work

NONE = "none"
# (name, parent, thread, start_ns, end_ns)
Span = Tuple[str, Optional[int], int, int, int]
# (name, is_device, start_ns, end_ns, correlation id, thread)
Event = Tuple[str, bool, int, int, int, int]


@dataclass
class Program:
    """The program's spans and counters over a stretch, with the stretch's
    device and idle seconds by the index of the span they went to (None: no
    span)."""

    spans: List[Span]
    counters: Dict[str, int]
    thread: int  # the thread that recorded
    device_s: Dict[Optional[int], float] = field(default_factory=dict)
    idle_s: Dict[Optional[int], float] = field(default_factory=dict)  # gaps of 20 us or more
    short_idle_s: float = 0.0

    def calls(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def ancestors(self, i: Optional[int]):
        """``i`` and the spans that enclose it, innermost first."""
        while i is not None:
            yield i
            i = self.spans[i][1]

    def seconds(self, keep: Callable[[Span], bool], outermost: bool = False) -> float:
        """Host seconds of the spans ``keep`` takes; with ``outermost``, of
        those not inside another that it takes."""
        total = 0
        for i, s in enumerate(self.spans):
            if keep(s) and not (outermost and any(keep(self.spans[a])
                                                  for a in self.ancestors(s[1]))):
                total += s[4] - s[3]
        return total * 1e-9

    def device(self, names: Sequence[str]) -> float:
        """Device seconds that went to a span named in ``names``."""
        return sum(v for i, v in self.device_s.items()
                   if i is not None and self.spans[i][0] in names)

    def idle_under(self, keep: Callable[[str], bool]) -> float:
        """Idle seconds that went to a span whose name, or an enclosing
        span's, ``keep`` takes."""
        return sum(v for i, v in self.idle_s.items()
                   if any(keep(self.spans[a][0]) for a in self.ancestors(i)))

    def by_name(self, seconds: Dict[Optional[int], float]) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for i, v in seconds.items():
            out[NONE if i is None else self.spans[i][0]] += v
        return dict(out)


class _Innermost:
    """The innermost span open on a thread at a time."""

    def __init__(self, spans: List[Span]):
        self.spans = spans
        by_thread: Dict[int, List[int]] = defaultdict(list)
        for i, s in enumerate(spans):
            by_thread[s[2]].append(i)
        self.order = {t: sorted(ix, key=lambda i: spans[i][3]) for t, ix in by_thread.items()}
        self.starts = {t: [spans[i][3] for i in ix] for t, ix in self.order.items()}

    def __call__(self, thread: int, t: int) -> Optional[int]:
        starts = self.starts.get(thread)
        if not starts:
            return None
        k = bisect.bisect_right(starts, t) - 1
        i = self.order[thread][k] if k >= 0 else None
        # spans on a thread nest: the innermost one open at t encloses the
        # last one that opened before it
        while i is not None and self.spans[i][4] <= t:
            i = self.spans[i][1]
        return i


def reduce(events: List[Event], spans: List[Span], counters: Dict[str, int], thread: int,
           harness: List[Tuple[str, int, int]], origin: int, end: int
           ) -> Tuple[Program, Dict[str, float]]:
    """The stretch ``[origin, end)`` reduced by program span: the
    :class:`Program`, and the idle seconds by gap name (the breakdown's
    ``idle_gaps``)."""
    prog = Program(spans=spans, counters=counters, thread=thread)
    innermost = _Innermost(spans)

    def owner(th: int, t: int) -> Optional[int]:
        i = innermost(th, t)
        return innermost(thread, t) if i is None and th != thread else i

    calls = sorted((s, e, n, th) for n, dev, s, e, _, th in events if not dev and e > s)
    launched = {c: (s, th) for n, dev, s, e, c, th in events if not dev and e > s}
    device_ops = [(max(s, origin), min(e, end), c) for n, dev, s, e, c, _ in events
                  if dev and e > s and e > origin and s < end]
    device_s: Dict[Optional[int], float] = defaultdict(float)
    for s, e, c in device_ops:
        call = launched.get(c)
        device_s[None if call is None else owner(call[1], call[0])] += (e - s) * 1e-9
    prog.device_s = dict(device_s)

    intervals = sorted((s, e) for s, e, _ in device_ops)
    gaps, cursor = [], origin
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((cursor, end))
    bench_spans = sorted((s, e, n) for n, s, e in harness)
    starts = [c[0] for c in calls]
    idle_s: Dict[Optional[int], float] = defaultdict(float)
    named: Dict[str, float] = defaultdict(float)
    short = f"gaps under {trace.SHORT_GAP_NS // 1000} us"
    for g0, g1 in gaps:
        seconds = (g1 - g0) * 1e-9
        if g1 - g0 < trace.SHORT_GAP_NS:
            named[short] += seconds
            prog.short_idle_s += seconds
            continue
        mid = (g0 + g1) // 2
        bench = next((n for s, e, n in reversed(bench_spans) if s <= mid <= e), None)
        k = bisect.bisect_right(starts, mid) - 1
        other = calls[k][2] if k >= 0 and calls[k][1] >= mid else "python"
        i = owner(calls[k][3] if k >= 0 else thread, mid)
        idle_s[i] += seconds
        name = None if i is None else spans[i][0]
        named["/".join(x for x in (bench, name, other) if x)] += seconds
    prog.idle_s = dict(idle_s)
    return prog, dict(named)


def _events(prof) -> List[Event]:
    """Every event of the raw Kineto results with its correlation id and
    thread: a runtime call's ``device_resource_id`` is the low 32 bits of
    the calling thread's pthread id, as CUPTI records it, taken unsigned as
    the program's recorder takes it."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        out.append((ev.name(), ev.device_type() == DeviceType.CUDA, start,
                    start + ev.duration_ns(), ev.correlation_id(),
                    ev.device_resource_id() & 0xFFFFFFFF))
    return out


def _recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from pwclonet_pylidarslam_torch.utils import timer
    except ImportError:
        return None
    return timer if hasattr(timer, "recording") else None


# the Program of the last stretch profiled, for the result's breakdown
_last: List[Program] = []


def profile(run, device: torch.device) -> trace.Stretch:
    """``trace.profile`` with the program's recording on over ``run``: the
    same stretch, its idle gaps named by program span, and its
    :class:`Program` as ``stretch.program``."""
    timer = _recorder()
    if timer is None:
        return _wrapped["profile"](run, device)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    spans = trace.Spans()
    with torch_profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        trace._sync(device)
        origin = time.time_ns()
        with timer.recording() as rec:
            calls, units = run(spans)
        trace._sync(device)
        end = time.time_ns()
    events = _events(prof)
    device_ops = [(n, max(s, origin), min(e, end)) for n, dev, s, e, _, _ in events
                  if dev and e > s and e > origin and s < end]
    program, idle = reduce(events, rec.spans, rec.counters, rec.thread, spans.spans,
                           origin, end)
    stretch = trace.Stretch(device_ops=[(n, (s - origin) * 1e-9, (e - origin) * 1e-9)
                                        for n, s, e in device_ops],
                            window_s=(end - origin) * 1e-9, calls=calls, units=units,
                            idle_by_host=idle)
    stretch.program = program
    _last[:] = [program]
    return stretch


def run_cell(*args, **kwargs) -> Dict:
    """``runner.run_cell``, its breakdown with the device seconds by program
    span (the top ten, and ``none``) and the program's counters."""
    _last.clear()
    result = _wrapped["run_cell"](*args, **kwargs)
    if _last and "breakdown" in result:
        program = _last.pop()
        by_name = sorted(program.by_name(program.device_s).items(), key=lambda kv: -kv[1])
        result["breakdown"]["device_by_span"] = [[k, v] for k, v in by_name[:10]]
        result["breakdown"]["counters"] = dict(program.counters)
    return result


_wrapped: Dict[str, Callable] = {}


def install() -> None:
    """Route the harness's profile and run through this module; once."""
    if _wrapped:
        return
    _wrapped.update(profile=trace.profile, run_cell=runner.run_cell)
    trace.profile = profile
    runner.run_cell = run_cell


# ------------------------------------------------------------------ readers


def of(rec) -> Optional[Program]:
    return getattr(rec.stretch, "program", None) if rec.stretch is not None else None


def ms_per(rec, keep: Callable[[Span], bool], per: Callable[[Program], int],
           outermost: bool = False) -> Optional[float]:
    """Host ms of the spans ``keep`` takes over ``per(program)``."""
    p = of(rec)
    if p is None or not per(p):
        return None
    return 1e3 * p.seconds(keep, outermost) / per(p)


def idle_share(rec, keep: Callable[[str], bool]) -> Optional[float]:
    """Idle seconds that went to a span ``keep`` takes (or inside one), in
    percent of the stretch's wall time."""
    p = of(rec)
    if p is None or rec.stretch.window_s <= 0 or not p.spans:
        return None
    return 100.0 * p.idle_under(keep) / rec.stretch.window_s


def roofline(rec, names: Sequence[str], bound_of) -> Optional[float]:
    """The stretch's bound over the device time that went to the spans
    named in ``names``; None where none went there."""
    p = of(rec)
    if p is None:
        return None
    return work.share(bound_of(rec.work) * rec.stretch.units, p.device(names))


POINT_OPS = ("op.fps", "op.knn", "op.gather", "op.scatter_plan", "op.scatter_sum")
FUSED_OPS = ("op.mlp_maxpool", "op.attentive_aggregate")
