"""What every driver shares: the result of a call, the harness's spans
around the input pipeline, the seconds of each stage of set-up, and the
first three steps of a training cell as the check reads them."""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch


class Done(NamedTuple):
    units: int  # samples or frames completed by the call
    work_units: int  # samples or pairs the network processed
    ok: bool  # every output of the call finite


class Feed:
    """An endless batch iterator with the harness's span around each
    ``next()``: its host seconds and count, and the first ``keep`` batches
    as they were handed over."""

    def __init__(self, epochs: Iterator[Iterator[Dict]], keep: int = 3):
        self._epochs = epochs
        self._it: Iterator[Dict] = iter(())
        self.kept: List[Dict] = []
        self.keep = keep
        self.seconds = 0.0
        self.count = 0
        self.spans = None  # a trace.Spans while a stretch is profiled

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        while True:
            try:
                batch = next(self._it)
                break
            except StopIteration:
                self._it = next(self._epochs)
        self.seconds += time.perf_counter() - t0
        if self.spans is not None:
            self.spans.spans.append(("bench.input", t0_ns, time.time_ns()))
        self.count += 1
        if len(self.kept) < self.keep:
            self.kept.append(copy.deepcopy(batch))
        return batch


class Phases:
    """Host seconds of each named stage of a driver's set-up, for the run's
    log on standard error."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def on_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class Base:
    """A driver's defaults: no counters of its own."""

    train = False
    fused = False
    batch = 1

    @property
    def counters(self) -> Dict[str, float]:
        return {}

    def reset_counters(self) -> None:
        pass
