"""The work counted from a configuration's shapes, and the shares computed
from it, against hand counts at small shapes."""

import json

import pytest
import torch

from tiny import ROOT, shrink_config

from benchmark.harness import peaks, readers, runner, trace, work
from benchmark.reference import params, pointnet2, pwclonet

BW, FP32, TF32 = peaks.HBM_BYTES_PER_S, peaks.FP32_FLOPS, peaks.TF32_FLOPS


def _config(name):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


def test_point_kernel_bounds_by_hand():
    # FPS, 2 clouds of 10 points, 4 samples: 3 steps of 8 operations a point;
    # the points read and the indices written
    assert work.fps_bound_s(2, 10, 4) == max(4 * (60 + 8) / BW, 8 * 2 * 10 * 3 / FP32)
    # kNN, 4 queries in 10 points, k=3: 8 operations a pair; both clouds read,
    # distances and indices written
    assert work.knn_bound_s(1, 4, 10, 3) == max(4 * (12 + 30 + 24) / BW, 8 * 40 / FP32)
    # gather of 6 rows of 5: the index read and the rows written
    assert work.gather_bound_s(1, 6, 5) == 4 * (6 + 30) / BW
    # scatter-add of 6 rows of 5 into 10: updates and index read, output written
    assert work.scatter_bound_s(1, 10, 6, 5) == 4 * (30 + 6 + 50) / BW
    # a fused block of 1,000 multiply-adds and 400 bytes: 3xTF32 takes 6 flops
    assert work.fused_bound_s(1000, 400) == max(400 / BW, 6000 / TF32)


def test_fps_bound_is_at_most_the_arithmetic_of_a_plain_step():
    # a step of the plain loop: 3 differences, 3 squares, 2 adds, a min and
    # a compare a point; the bound counts 8 of them
    assert work.FPS_OPS_PER_POINT_STEP <= 10 and work.KNN_OPS_PER_PAIR <= 10


@pytest.mark.parametrize("train,fused,counts", [
    (True, False, {"fps": 5, "knn": 19, "gather": 24, "scatter": 18, "mlp_maxpool": 0,
                   "attentive_aggregate": 0}),
    (False, True, {"fps": 5, "knn": 19, "gather": 24, "scatter": 0, "mlp_maxpool": 15,
                   "attentive_aggregate": 8}),
])
def test_pwclonet_calls_match_the_programs_launches(train, fused, counts):
    """The walker's calls a step or a forward are the launches the program
    makes at these widths (PERF.md, kernel table)."""
    w = work.work_of(_config("pwclonet-kitti"), 8, train, fused)
    assert {k: w.count(k) for k in counts} == counts


def test_semseg_calls_match_the_programs_launches():
    w = work.work_of(_config("pointnet2-semseg-ssg"), 32, True)
    assert {k: w.count(k) for k in ("fps", "knn", "gather", "scatter")} == \
        {"fps": 4, "knn": 4, "gather": 12, "scatter": 7}


class _CountMatmuls(torch.overrides.TorchFunctionMode):
    """Multiply-adds of every matmul and linear the reference calls."""

    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.matmul, torch.Tensor.matmul):
            x, w = args[0], args[1]
            self.macs += x.numel() // x.shape[-1] * w.shape[0] * w.shape[1]
        elif func is torch.nn.functional.linear:
            x, w = args[0], args[1]
            self.macs += x.numel() // x.shape[-1] * w.shape[0] * w.shape[1]
        return func(*args, **kwargs)


@pytest.mark.parametrize("name", ["pwclonet-kitti", "pointnet2-semseg-ssg"])
def test_dense_macs_match_the_reference_forward(name):
    c = shrink_config(_config(name))
    w = params.make_weights(c, 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    b = 2
    counter = _CountMatmuls()
    with torch.no_grad(), counter:
        if c["model"] == "pwclonet":
            x = torch.randn(2, b, c["num_points"], 3, generator=g) * 10
            pwclonet.Net(c, w)(x[0], x[1])
        else:
            pts = torch.rand(b, c["num_points"], c["in_channels"], generator=g)
            pointnet2.forward(c, w, pts[..., :3], pts[..., 3:], False, "float32")
    assert work.work_of(c, b, False).dense_macs == counter.macs


def test_semseg_products_by_hand():
    # three-NN interpolation: 3 multiply-adds a channel of each unknown point
    c = shrink_config(_config("pointnet2-semseg-ssg"))
    sizes = [256, 64, 32, 16, 8]
    widths = [512, 256, 256, 256]  # the known features at levels 3, 2, 1, 0
    expected = sum(sizes[level] * 3 * wd for level, wd in zip((3, 2, 1, 0), widths))
    assert work.work_of(c, 1, False).product_macs == expected


def _record(units, elapsed, stretch=None, train=True, batch=8, w=None):
    win = runner.Window(elapsed_s=elapsed, calls=1, units=units, work_units=units)
    return runner.Record(setup_s=1.0, window=win, counters={},
                         work=w or work.Work(dense_macs=1_000_000, product_macs=0),
                         train=train, batch=batch, stretch=stretch)


def test_mfu_arithmetic():
    # 1e6 multiply-adds a sample, trained: 6e6 flops a sample; 1e6 samples in
    # 2 s is 3e12 flop/s, of 165e12
    rec = _record(1_000_000, 2.0)
    assert readers.mfu(rec) == pytest.approx(100 * 3e12 / (495e12 / 3))
    assert readers.mfu(_record(1_000_000, 2.0, train=False)) == pytest.approx(
        100 * 1e12 / 165e12)


def test_roofline_and_idle_arithmetic():
    w = work.Work()
    w.ops.append(("scatter", 1, 1000, 1000, 10))  # one unit's work
    bound = work.point_bound_s(w)
    ops = [("(anonymous namespace)::scatter_sum_kernel(SumArgs)", 0.0, 2 * bound),
           ("void at::native::elementwise_kernel<128>", 3 * bound, 4 * bound)]
    s = trace.Stretch(device_ops=ops, window_s=8 * bound, calls=1, units=1)
    rec = _record(1, 1.0, stretch=s, w=w)
    patterns = [readers.PROGRAM_KERNEL + r"scatter_(rank|scan|fill|sum)_kernel\b"]
    assert readers.roofline(rec, patterns, work.point_bound_s) == pytest.approx(50.0)
    assert readers.idle(rec) == pytest.approx(100 * (1 - 3 / 8))
    assert readers.launches_per_step(rec) == pytest.approx(2 * 8)
    # nothing matched: no reading, never 0
    assert readers.roofline(rec, [r"\bnothing_kernel\b"], work.point_bound_s) is None


def test_library_kernels_do_not_match_the_programs_patterns():
    pat = trace.compile_patterns([readers.PROGRAM_KERNEL + r"(fps|knn|gather)_kernel\b"])
    assert pat.search("(anonymous namespace)::gather_kernel(float const*, int)")
    assert pat.search("void (anonymous namespace)::fps_kernel<8, true, false>(float const*)")
    assert not pat.search("void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)")
