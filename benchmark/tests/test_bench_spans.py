"""The profiled stretch reduced by the program's spans
(``benchmark/harness/program_trace.py``), on hand-made events, and the
readers of the metrics that read it."""

import pytest
import torch

from tiny import ROOT, SEED, tiny_cell

from benchmark.harness import manifest, program_trace, readers, runner, trace, work

US = 1000  # ns
MAIN, WORKER = 100, 200  # the recording thread, and the autograd engine's
SPANS = [
    ("train.step", None, MAIN, 0, 1000 * US),
    ("train.forward", 0, MAIN, 10 * US, 400 * US),
    ("op.knn", 1, MAIN, 50 * US, 100 * US),
    ("train.backward", 0, MAIN, 400 * US, 900 * US),
    ("op.scatter_sum", None, WORKER, 500 * US, 600 * US),
    ("data.pair", None, MAIN, 1000 * US, 1400 * US),
    ("data.filter", 5, MAIN, 1010 * US, 1300 * US),
]
KNN = "void (anonymous namespace)::knn_kernel<32>(float const*, int)"
SCATTER = "(anonymous namespace)::scatter_sum_kernel(SumArgs)"
EVENTS = [  # (name, is_device, start_ns, end_ns, correlation id, thread)
    ("cudaLaunchKernel", False, 60 * US, 70 * US, 1, MAIN),
    ("cudaMemcpyAsync", False, 80 * US, 90 * US, 6, MAIN),
    ("cudaLaunchKernel", False, 150 * US, 160 * US, 2, MAIN),
    ("cudaLaunchKernel", False, 510 * US, 520 * US, 3, WORKER),
    ("cudaLaunchKernel", False, 600 * US, 610 * US, 4, WORKER),
    ("cudaStreamSynchronize", False, 950 * US, 960 * US, 5, MAIN),
    (KNN, True, 80 * US, 120 * US, 1, 0),
    ("Memcpy DtoD (Device -> Device)", True, 100 * US, 110 * US, 6, 0),
    ("void at::native::elementwise_kernel<128>", True, 170 * US, 300 * US, 2, 0),
    (SCATTER, True, 530 * US, 560 * US, 3, 0),
    ("void at::native::batch_norm_backward_kernel", True, 620 * US, 700 * US, 4, 0),
    ("void at::native::unrecorded_kernel", True, 1500 * US, 1510 * US, 99, 0),
]
HARNESS = [("bench.call", 0, 2000 * US)]


def _program():
    return program_trace.reduce(EVENTS, SPANS, {"train.steps": 1}, MAIN, HARNESS, 0, 2000 * US)


def _record():
    program, idle = _program()
    ops = [(n, s * 1e-9, e * 1e-9) for n, dev, s, e, _, _ in EVENTS if dev]
    stretch = trace.Stretch(device_ops=ops, window_s=2000 * US * 1e-9, calls=1, units=1,
                            idle_by_host=idle)
    stretch.program = program
    w = work.Work()
    w.ops += [("knn", 1, 2048, 8192, 32), ("scatter", 1, 1000, 1000, 10)]
    return runner.Record(setup_s=0.0, window=runner.Window(), counters={}, work=w, train=True,
                         batch=1, stretch=stretch)


def test_device_and_idle_time_by_span_sum_to_the_stretch():
    program, idle = _program()
    device = program.by_name(program.device_s)
    assert device == pytest.approx({
        "op.knn": 50e-6,  # the kernel and the copy launched inside the span
        "train.forward": 130e-6,
        "op.scatter_sum": 30e-6,  # launched by the worker inside its own span
        "train.backward": 80e-6,  # by the worker outside any: the caller's span
        "none": 10e-6,  # no runtime call recorded
    })
    summed = sum(e - s for n, dev, s, e, _, _ in EVENTS if dev) * 1e-9
    assert sum(device.values()) == pytest.approx(summed)
    busy = 290e-6  # the union of the device operations
    assert sum(idle.values()) == pytest.approx(2000e-6 - busy)
    assert sum(program.idle_s.values()) + program.short_idle_s == pytest.approx(2000e-6 - busy)
    assert idle == pytest.approx({
        "bench.call/train.forward/python": 80e-6 + 50e-6,
        "bench.call/train.backward/python": 230e-6,
        "bench.call/op.scatter_sum/python": 60e-6,
        "bench.call/data.filter/python": 800e-6,
        "bench.call/python": 490e-6,  # outside any span: the harness's name
    })


def test_a_gap_during_a_worker_span_is_named_by_it():
    """The gap 560–620 us follows the worker's launch at 510 us, inside its
    op.scatter_sum; the main thread is in train.backward then."""
    program, idle = _program()
    by_span = program.by_name(program.idle_s)
    assert by_span["op.scatter_sum"] == pytest.approx(60e-6)
    assert idle["bench.call/op.scatter_sum/python"] == pytest.approx(60e-6)


def test_short_gaps_are_summed_apart():
    events = [("k", True, 0, 10 * US, 1, 0), ("k", True, 15 * US, 30 * US, 2, 0)]
    program, idle = program_trace.reduce(events, SPANS[:1], {}, MAIN, HARNESS, 0, 30 * US)
    assert idle == pytest.approx({"gaps under 20 us": 5e-6})
    assert program.idle_s == {} and program.short_idle_s == pytest.approx(5e-6)


def _metric(name):
    return manifest.load_module(ROOT / f"benchmark/metrics/{name}.py", "t_" + name)


def test_the_span_metrics_read_the_spans():
    rec = _record()
    assert _metric("feed_idle.train").read(rec) == pytest.approx(100 * 800 / 2000)
    assert _metric("dispatch_ms_per_step.train").read(rec) == pytest.approx(0.39 + 0.5)
    # the outermost data span alone
    assert _metric("feed_ms_per_step.train").read(rec) == pytest.approx(0.4)
    assert program_trace.idle_share(rec, lambda n: n == "train.step") == pytest.approx(
        100 * (130 + 230) / 2000)


def test_span_rooflines_read_at_or_below_the_name_matched_ones():
    rec = _record()
    spans = _metric("point_ops_roofline.train").read(rec)
    names = _metric("point_kernels_roofline.train").read(rec)
    bound = work.point_bound_s(rec.work)
    assert names == pytest.approx(100 * bound / 70e-6)
    assert spans == pytest.approx(100 * bound / 80e-6)  # the copy in op.knn too
    assert spans <= names
    assert _metric("fused_ops_roofline.odometry").read(rec) is None  # no fused span
    assert readers.idle(rec) == pytest.approx(100 * (1 - 290 / 2000))


def test_nothing_to_read_without_the_programs_spans():
    rec = _record()
    rec.stretch.program = None
    for name in ("prepare_ms_per_call.odometry", "prepare_idle.odometry", "feed_ms_per_step.train",
                 "feed_idle.train", "dispatch_ms_per_step.train", "point_ops_roofline.train",
                 "point_ops_roofline.odometry", "fused_ops_roofline.odometry"):
        assert _metric(name).read(rec) is None, name


def test_a_program_without_the_recorder_gets_the_harness_profile(monkeypatch):
    program_trace.install()
    calls = []
    monkeypatch.setattr(program_trace, "_recorder", lambda: None)
    monkeypatch.setitem(program_trace._wrapped, "profile",
                        lambda run, device: calls.append(device) or "harness")
    assert trace.profile(lambda spans: (1, 1), torch.device("cpu")) == "harness"
    assert calls == [torch.device("cpu")]


def test_a_traced_cpu_run_reports_the_programs_spans():
    """The odometry cell at a small size on the CPU (no device operations):
    the host metrics read, the breakdown carries the counters."""
    cell = tiny_cell("pwclonet-odometry-seq32")
    result = runner.run_cell(cell, SEED, 0.2, True, torch.device("cpu"), 0.0)
    assert result["correct"]
    assert result["metrics"]["prepare_ms_per_call.odometry"]["value"] > 0
    counters = result["breakdown"]["counters"]
    assert counters["odometry.points_in"] > 0 and counters["h2d.bytes"] > 0
    assert "device_by_span" in result["breakdown"]
