"""Spans and counters inside the program, the profiler hook, and timing helpers.

:func:`span` marks a stretch of the program's host time by name (``layer.what``,
as ``odometry.prepare`` or ``op.knn``), as a ``with`` block or a decorator;
:func:`count` adds to a named counter. Both cost next to nothing while no
recording is on: :func:`span` returns its name's shared no-op, which
allocates nothing and reads no clock. Inside :func:`recording` each span
keeps ``(name, parent, thread, start_ns, end_ns)`` in memory: ``parent`` is
the index of the innermost span then open on the same thread (the stack is
thread-local, since the autograd engine runs the CUDA backward on a thread of
its own), ``thread`` the id the CUDA profiler gives the runtime calls that the
thread makes, and the clock is ``time.time_ns()``, the one the profiler's
events carry; nothing is written until the recording ends.

:func:`profiler_trace` records a ``torch.profiler`` trace, CPU activity and,
on the card, CUDA activity, into a Chrome trace file that Perfetto
(ui.perfetto.dev) and TensorBoard open; it turns the recording on as well,
and each span then also enters ``torch.profiler.record_function``, so the
trace shows the same names.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

from pwclonet_pylidarslam_torch.device import resolve_device


def thread_id() -> int:
    """The id the CUDA profiler gives the runtime calls this thread makes:
    the low 32 bits of its pthread id, which CUPTI records (Kineto hands it
    on as a runtime call's ``device_resource_id``, a signed int32)."""
    return threading.get_ident() & 0xFFFFFFFF


@dataclass
class Record:
    """What a recording kept: ``spans`` as ``(name, parent, thread, start_ns,
    end_ns)`` in the order they opened (``parent`` an index into ``spans``,
    or None), the ``counters``, and the ``thread`` that recorded. Filled when
    the recording ends."""

    thread: int
    spans: List[Tuple[str, Optional[int], int, int, int]] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)


class _Recording:
    """The state of the recording that is on: each span's entry ``[name,
    parent entry, thread, start_ns, end_ns]``, the stacks of open spans by
    thread, and the counters."""

    def __init__(self, ranges: bool):
        self.ranges = ranges
        self.entries: List[list] = []
        self.local = threading.local()
        self.counters: Dict[str, int] = {}
        self.lock = threading.Lock()

    def stack(self) -> Tuple[list, int]:
        local = self.local
        try:
            return local.stack, local.thread
        except AttributeError:
            local.stack, local.thread = [], thread_id()
            return local.stack, local.thread


_active: Optional[_Recording] = None


class _Decorator:
    __slots__ = ()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Off(_Decorator):
    """A name's span while no recording is on."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _On(_Decorator):
    """One span of a recording."""

    __slots__ = ("name", "rec", "entry", "stack", "range")

    def __init__(self, name: str, rec: _Recording):
        self.name, self.rec = name, rec

    def __enter__(self):
        stack, thread = self.rec.stack()
        self.entry = [self.name, stack[-1] if stack else None, thread, time.time_ns(), 0]
        self.rec.entries.append(self.entry)
        stack.append(self.entry)
        self.stack = stack
        self.range = None
        if self.rec.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.entry[4] = time.time_ns()
        self.stack.pop()
        return False


_OFF: Dict[str, _Off] = {}


def span(name: str):
    """A named stretch of host time, as ``with span(name):`` or
    ``@span(name)``. With no recording on, the name's shared no-op."""
    rec = _active
    if rec is None:
        off = _OFF.get(name)
        if off is None:
            off = _OFF.setdefault(name, _Off(name))
        return off
    return _On(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording that is on."""
    rec = _active
    if rec is not None:
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(ranges: bool = False) -> Iterator[Record]:
    """Turn the spans and counters on for the block; yields the
    :class:`Record`, which is filled when the block ends. ``ranges``: each
    span also enters ``torch.profiler.record_function``. Recordings do not
    nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording of spans is already on")
    rec = _Recording(ranges)
    out = Record(thread=thread_id())
    _active = rec
    try:
        yield out
    finally:
        _active = None
        end = time.time_ns()
        index = {id(e): i for i, e in enumerate(rec.entries)}
        out.spans = [(name, None if parent is None else index[id(parent)], thread, start,
                      stop or end)
                     for name, parent, thread, start, stop in rec.entries]
        out.counters = dict(rec.counters)


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


def wait_for(result) -> None:
    """Wait until every CUDA device that holds a tensor of ``result`` (a
    tensor, or lists, tuples and dicts of them) has finished its work."""
    for device in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiler_trace(log_dir: str, device: Union[str, torch.device] = "cuda"):
    """Record a ``torch.profiler`` trace of the block into
    ``log_dir/trace_<pid>_<time>.json`` (Chrome trace format), the program's
    spans among its ranges. On a CUDA ``device`` the trace holds CUDA
    activity as well, and a trace in which none was recorded raises instead
    of passing for the CPU's alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording(ranges=True):
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda and not any(e.device_type() == DeviceType.CUDA
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity on the card")
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)


def timed_call(fn, *args, n: int = 5, warmup: int = 1):
    """Mean seconds of ``fn(*args)`` over ``n`` calls after ``warmup``
    calls, each waited for on its device; returns ``(seconds, last output)``."""
    for _ in range(warmup):
        wait_for(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
        wait_for(out)
    return (time.perf_counter() - t0) / n, out
