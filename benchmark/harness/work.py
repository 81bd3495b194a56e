"""The work of one step, counted from a configuration's shapes.

For each configuration a walker lists what one forward does, layer by
layer: every dense layer (rows, input width, output width), every attention
or interpolation product, and every call of a point op (furthest point
sampling, kNN, gather, and the gather's scatter-add in a backward) and of a
fused block (MLP + max-pool, attentive aggregate). Nothing here reads the
program's calls: a later kernel that does the same work is judged on the
same count.

- Model FLOPs: 2 × the multiply-adds of the dense layers and products; the
  forward once, a training step three times.
- A kernel's bound: the larger of its bytes over the HBM bandwidth and its
  operations over the peak of the arithmetic it needs, each input byte read
  once and each output byte written once. Counts stay at or under what the
  kernel must do, so no share of a bound can pass 100 % by a miscount.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness import peaks

# operations a kernel needs per element of its work
FPS_OPS_PER_POINT_STEP = 8  # 3 differences, 3 squares, 2 adds
KNN_OPS_PER_PAIR = 8  # 3 products and 2 adds of the dot, 2 adds and a product of the formula


@dataclass
class Work:
    """What one forward (or one step's forward and backward) does."""

    dense_macs: int = 0  # of the dense layers
    product_macs: int = 0  # of the attention and interpolation products
    ops: List[Tuple] = field(default_factory=list)

    def dense(self, rows: int, cin: int, cout: int) -> None:
        self.dense_macs += rows * cin * cout

    def mlp(self, rows: int, cin: int, widths: Sequence[int]) -> int:
        for cout in widths:
            self.dense(rows, cin, cout)
            cin = cout
        return cin

    def product(self, macs: int) -> None:
        self.product_macs += macs

    def count(self, kind: str) -> int:
        return sum(1 for op in self.ops if op[0] == kind)


def model_flops(work: Work, train: bool) -> float:
    """2 × multiply-adds, three times over for a forward and backward."""
    return 2.0 * (work.dense_macs + work.product_macs) * (3 if train else 1)


def fps_bound_s(b: int, n: int, npoint: int) -> float:
    ops = FPS_OPS_PER_POINT_STEP * b * n * (npoint - 1)
    nbytes = 4 * (3 * b * n + b * npoint)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)


def knn_bound_s(b: int, s: int, n: int, k: int) -> float:
    ops = KNN_OPS_PER_PAIR * b * s * n
    nbytes = 4 * (3 * b * s + 3 * b * n + 2 * b * s * k)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)


def gather_bound_s(b: int, m: int, c: int) -> float:
    # the index read and the rows written; the rows read are not counted,
    # since repeated indices may read fewer than M
    return 4 * (b * m + b * m * c) / peaks.HBM_BYTES_PER_S


def scatter_bound_s(b: int, n: int, m: int, c: int) -> float:
    return 4 * (b * m * c + b * m + b * n * c) / peaks.HBM_BYTES_PER_S


def fused_bound_s(macs: int, nbytes: int) -> float:
    """3xTF32 on the tensor cores: three TF32 products a multiply-add."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, 6.0 * macs / peaks.TF32_FLOPS)


def point_bound_s(work: Work) -> float:
    """The bound of every FPS, kNN, gather and scatter-add in ``work``."""
    total = 0.0
    for op in work.ops:
        kind, args = op[0], op[1:]
        if kind == "fps":
            total += fps_bound_s(*args)
        elif kind == "knn":
            total += knn_bound_s(*args)
        elif kind == "gather":
            total += gather_bound_s(args[0], args[2], args[3])
        elif kind == "scatter":
            total += scatter_bound_s(*args)
    return total


def fused_bound_total_s(work: Work) -> float:
    return sum(fused_bound_s(op[1], op[2]) for op in work.ops
               if op[0] in ("mlp_maxpool", "attentive_aggregate"))


# ------------------------------------------------------------------ PWCLO-Net


class _PwcloWalker:
    def __init__(self, c: Dict, batch: int, train: bool, fused: bool):
        self.c, self.b, self.train, self.fused = c, batch, train, fused
        self.w = Work()

    def gather(self, b, n, m, c, grad):
        self.w.ops.append(("gather", b, n, m, c))
        if self.train and grad:
            self.w.ops.append(("scatter", b, n, m, c))

    def maxpool_mlp(self, b, s, k, cin, widths):
        """An MLP over ``(b, s, k, cin)`` and the max over k."""
        rows = b * s * k
        if self.fused and not self.train:
            macs, c = 0, cin
            for cout in widths:
                macs += rows * c * cout
                c = cout
            self.w.ops.append(("mlp_maxpool", macs,
                               4 * (rows * cin + b * s * widths[-1] + _weights(cin, widths))))
        return self.w.mlp(rows, cin, widths)

    def sample_group(self, b, n, s, k, c_feat):
        """FPS, the centres' gather, kNN and the grouping; ``c_feat`` None
        groups the raw xyz (the first level)."""
        self.w.ops.append(("fps", b, n, s))
        self.gather(b, n, s, 3, grad=False)
        self.w.ops.append(("knn", b, s, n, k))
        self.gather(b, n, s * k, 3 + (c_feat or 0), grad=c_feat is not None)

    def cost_volume(self, b, s, n2, c1, c2, k, kq, cv):
        d = cv["mlp1"][-1]
        self.w.ops.append(("knn", b, s, n2, kq))
        self.gather(b, n2, s * kq, 3 + c2, grad=True)
        rows = b * s * kq
        macs = self.w.dense_macs
        self.w.mlp(rows, 10 + c1 + c2, cv["mlp1"])
        self.w.mlp(rows, 10, (d,))
        self.w.mlp(rows, 2 * d, cv["mlp2"])
        self.w.product(rows * d)
        if self.fused and not self.train:
            self.w.ops.append(("attentive_aggregate", self.w.dense_macs - macs,
                               4 * (b * s * 3 + rows * 3 + b * s * c1 + rows * c2 + b * s * d
                                    + _weights(10 + c1 + c2, cv["mlp1"])
                                    + _weights(10, (d,)) + _weights(2 * d, cv["mlp2"]))))
        self.w.ops.append(("knn", b, s, s, k))
        self.gather(b, s, s * k, 3 + d, grad=True)
        rows = b * s * k
        macs = self.w.dense_macs
        self.w.mlp(rows, 10, (d,))
        self.w.mlp(rows, d + c1 + d, cv["mlp2"])
        self.w.product(rows * d)
        if self.fused and not self.train:
            self.w.ops.append(("attentive_aggregate", self.w.dense_macs - macs,
                               4 * (b * s * 3 + rows * 3 + b * s * c1 + rows * d
                                    + b * s * cv["mlp2"][-1]
                                    + _weights(10, (d,)) + _weights(d + c1 + d, cv["mlp2"]))))

    def pose(self, b, s, emb, hidden):
        self.w.product(b * s * emb)
        self.w.dense(b, emb, hidden)
        self.w.dense(b, hidden, 4)
        self.w.dense(b, hidden, 3)

    def walk(self) -> Work:
        c, b = self.c, self.b
        n = c["num_points"]
        sizes = [n] + list(c["sa_npoints"])
        mlps = c["sa_mlps"]
        emb = c["embedding"]
        feat = None
        for lvl in range(4):
            s, k = c["sa_npoints"][lvl], c["sa_nsamples"][lvl]
            self.sample_group(2 * b, sizes[lvl], s, k, feat)
            cin = 3 + (3 if feat is None else feat)
            for _ in range(2):  # each frame's batch of statistics
                self.maxpool_mlp(b, s, k, cin, mlps[lvl])
            feat = mlps[lvl][-1]
        c1, c2, c3, c4 = (m[-1] for m in mlps)
        s3, s4 = sizes[3], sizes[4]
        cv = c["cost_volume"]
        self.cost_volume(b, s3, s3, c3, c3, cv["nsample"], cv["nsample_q"], cv)
        k4 = c["sa_nsamples"][3]
        self.sample_group(b, s3, s4, k4, emb)
        self.maxpool_mlp(b, s4, k4, 3 + emb, c["flow_encoding_mlp"])
        self.w.mlp(b * s4, c4 + emb, c["flow_predictor_mlp"])
        self.pose(b, s4, emb, c["pose_hidden"])
        r = c["refine"]
        coarse = s4
        for k, (fine_n, fine_c) in enumerate(((s3, c3), (sizes[2], c2), (sizes[1], c1))):
            for _ in range(2):  # feature and mask set-upconvs
                self.w.ops.append(("knn", b, fine_n, coarse, r["upconv_nsample"]))
                self.gather(b, coarse, fine_n * r["upconv_nsample"], emb + 3, grad=True)
                self.maxpool_mlp(b, fine_n, r["upconv_nsample"], emb + 3, r["upconv_mlp"])
                self.w.mlp(b * fine_n, r["upconv_mlp"][-1] + fine_c, r["upconv_post_mlp"])
            self.cost_volume(b, fine_n, fine_n, fine_c, fine_c, r["nsample"], r["nsample_q"], cv)
            self.w.mlp(b * fine_n, fine_c + 2 * emb, c["flow_predictor_mlp"])
            if k < 2:
                self.w.mlp(b * fine_n, fine_c + 2 * emb, c["flow_predictor_mlp"])
            self.pose(b, fine_n, emb, c["pose_hidden"])
            coarse = fine_n
        return self.w


def _weights(cin: int, widths: Sequence[int]) -> int:
    """Floats of an MLP's folded weights and biases."""
    total = 0
    for cout in widths:
        total += cin * cout + cout
        cin = cout
    return total


# ------------------------------------------------------------ PointNet++ semseg


def semseg_work(c: Dict, batch: int, train: bool) -> Work:
    w = Work()
    b = batch
    sizes = [c["num_points"]] + [st["npoint"] for st in c["stages"]]
    widths = [c["in_channels"] - 3]
    for i, st in enumerate(c["stages"]):
        s, k = st["npoint"], st["nsample"]
        w.ops.append(("fps", b, sizes[i], s))
        w.ops.append(("gather", b, sizes[i], s, 3))
        c_in = 3 + widths[-1]
        w.ops.append(("gather", b, sizes[i], s * k, c_in))
        if train and i > 0:  # the input's own features take no gradient
            w.ops.append(("scatter", b, sizes[i], s * k, c_in))
        widths.append(w.mlp(b * s * k, c_in, st["mlp"]))
    width = widths[-1]
    n = len(c["stages"])
    for level in range(n - 1, -1, -1):
        unknown, known = sizes[level], sizes[level + 1]
        w.ops.append(("knn", b, unknown, known, 3))
        w.ops.append(("gather", b, known, unknown * 3, width))
        if train:
            w.ops.append(("scatter", b, known, unknown * 3, width))
        w.product(b * unknown * 3 * width)
        wd = c["fp_width"] if level > 0 else c["head_width"]
        width = w.mlp(b * unknown, width + widths[level], (wd, wd))
    width = w.mlp(b * sizes[0], width, (c["head_width"],))
    w.dense(b * sizes[0], width, c["num_classes"])
    return w


def work_of(config: Dict, batch: int, train: bool, fused: bool = False) -> Work:
    """The work of one forward of ``batch`` samples (pairs, for PWCLO-Net),
    with the backward's scatter-adds when ``train``."""
    if config["model"] == "pwclonet":
        return _PwcloWalker(config, batch, train, fused).walk()
    if config["model"] == "pointnet2_semseg":
        return semseg_work(config, batch, train)
    raise ValueError(f"no walker for model {config['model']!r}")


def share(bound_s: float, time_s: Optional[float]) -> Optional[float]:
    """``bound / time`` in percent; None where nothing was timed."""
    if not time_s or time_s <= 0:
        return None
    return 100.0 * bound_s / time_s
