"""Timers and profiling hooks.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/utils/timer.py``. A timer
stops its clock only once the device of the result it times has finished
(``torch.cuda.synchronize`` on each CUDA device the result lies on), and
:func:`profiler_trace` records a ``torch.profiler`` trace, CPU activity and,
on the card, CUDA activity, into a Chrome trace file that Perfetto
(ui.perfetto.dev) and TensorBoard open.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Union

import torch

from pwclonet_pylidarslam_torch.device import resolve_device


class Duration:
    """Accumulating named timer."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @property
    def average(self) -> float:
        return self.total / max(self.count, 1)


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


class Timers:
    """Named section timers that wait for their result's device."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.durations: Dict[str, Duration] = defaultdict(Duration)

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        """Time the block. ``result`` (tensors, or a list or dict the block
        fills) is waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if self.sync and result is not None:
            wait_for(result)
        d = self.durations[name]
        d.total += time.perf_counter() - t0
        d.count += 1

    def summary(self) -> Dict[str, float]:
        return {k: v.average for k, v in self.durations.items()}


@contextlib.contextmanager
def profiler_trace(log_dir: str, device: Union[str, torch.device] = "cuda"):
    """Record a ``torch.profiler`` trace of the block into
    ``log_dir/trace_<pid>_<time>.json`` (Chrome trace format). On a CUDA
    ``device`` the trace holds CUDA activity as well, and a trace in which
    none was recorded raises instead of passing for the CPU's alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
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
