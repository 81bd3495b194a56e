"""Plain PyTorch building blocks of the reference networks: point ops, the
BatchNorm'd point MLP, dense heads, dropout, quaternions, and the matmul
precision a run asks for.

The point ops follow the semantics the configurations state: furthest point
sampling from the first valid point with ties to the lowest index; exact
k-nearest neighbours by a stable sort of ``max(|q|² + |r|² − 2 q·r, 0)``,
each dot product summed in channel order; gathers by indexing. Nothing here
imports the program. Networks are functions of a flat dict of named tensors
(parameters and running statistics under the names the benchmark gives the
program too).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Weights = Dict[str, torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the tensor cores' conversion does."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``x @ w`` with both operands rounded to TF32, accumulated in float32;
    the backward's products round their operands the same way."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(round_tf32(x), round_tf32(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        gx = torch.matmul(g, round_tf32(w).t())
        gw = torch.matmul(round_tf32(x).reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return gx, gw


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` (``w`` 2-d) in float32, or with operands rounded to TF32 or
    bfloat16 (accumulated in float32; the result float32)."""
    if precision == "float32":
        return torch.matmul(x, w)
    if precision == "tf32":
        return _TF32Matmul.apply(x, w)
    if precision == "bfloat16":
        return torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16)).float()
    raise ValueError(f"unknown precision {precision!r}")


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           precision: str) -> torch.Tensor:
    """``x @ weight.T + bias`` (``weight (out, in)``)."""
    if precision == "float32":
        return torch.nn.functional.linear(x, weight, bias)
    return matmul(x, weight.t(), precision) + bias


def n_layers(w: Weights, name: str) -> int:
    n = 0
    while f"{name}.kernel_{n}" in w:
        n += 1
    return n


def point_mlp(w: Weights, name: str, x: torch.Tensor, train: bool, precision: str,
              maxpool: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """(matmul → BatchNorm → ReLU) per layer over the last axis; in train mode
    the batch's mean and biased variance over every leading axis, else the
    running statistics; ``maxpool`` takes the max over axis −2 after."""
    for i in range(n_layers(w, name)):
        h = matmul(x, w[f"{name}.kernel_{i}"], precision)
        if train:
            var, mean = torch.var_mean(h.reshape(-1, h.shape[-1]), dim=0, unbiased=False)
        else:
            mean, var = w[f"{name}.mean_{i}"], w[f"{name}.var_{i}"]
        h = (h - mean) * torch.rsqrt(var + eps) * w[f"{name}.scale_{i}"] + w[f"{name}.bias_{i}"]
        x = torch.relu(h)
    return torch.amax(x, dim=-2) if maxpool else x


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout, the mask drawn from ``generator`` on ``x``'s device."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


# ---------------------------------------------------------------- point ops


def fps(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest point sampling ``(B, N, 3)`` → ``(B, npoint)`` int64. A point
    with ``|p|² <= 1e-3`` (padding) is picked only when no other is left."""
    b = points.shape[0]
    x, y, z = points.unbind(-1)
    valid = x * x + y * y + z * z > 1e-3
    big = torch.tensor(1e10, dtype=points.dtype, device=points.device)
    dist = torch.where(valid, big, -big)
    last = torch.argmax(dist, dim=-1)
    out = torch.empty((b, npoint), dtype=torch.long, device=points.device)
    out[:, 0] = last
    rows = torch.arange(b, device=points.device)
    for i in range(1, npoint):
        lp = points[rows, last]
        dx, dy, dz = x - lp[:, 0:1], y - lp[:, 1:2], z - lp[:, 2:3]
        dist = torch.minimum(dist, torch.where(valid, dx * dx + dy * dy + dz * dz, -big))
        last = torch.argmax(dist, dim=-1)
        out[:, i] = last
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``(B, S, N)`` squared distances ``max(|q|² + |r|² − 2 q·r, 0)``."""
    q2 = _dot(query, query)[:, :, None]
    r2 = _dot(ref, ref)[:, None, :]
    cross = _dot(query[:, :, None, :], ref[:, None, :, :])
    return torch.clamp_min(q2 + r2 - 2.0 * cross, 0.0)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, block_bytes: int = 1 << 28):
    """Exact kNN by a stable sort, ties to the lower index: ``(sqdists (B, S,
    k), idx (B, S, k) int64)``; ``k`` beyond N repeats the nearest. Computed
    a few samples at a time so that the distance matrix stays small."""
    b, s, _ = query.shape
    n = ref.shape[1]
    kk = min(k, n)
    per = max(1, block_bytes // max(1, 12 * s * n))
    ds, ids = [], []
    for lo in range(0, b, per):
        d = sqdist(query[lo: lo + per], ref[lo: lo + per])
        vals, idx = torch.sort(d, dim=-1, stable=True)
        ds.append(vals[..., :kk])
        ids.append(idx[..., :kk])
        del d, vals, idx
    d, i = torch.cat(ds), torch.cat(ids)
    if k > n:
        d = torch.cat([d, d[..., :1].expand(*d.shape[:-1], k - n)], dim=-1)
        i = torch.cat([i, i[..., :1].expand(*i.shape[:-1], k - n)], dim=-1)
    return d, i


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` by ``idx (B, M)`` → ``(B, M, C)``."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, N, C)`` by ``idx (B, M, K)`` → ``(B, M, K, C)``."""
    b, m, k = idx.shape
    return gather(points, idx.reshape(b, m * k)).reshape(b, m, k, points.shape[-1])


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` points by index within ``radius`` of each centre;
    a short row repeats its first hit, a row with none is 0."""
    n = points.shape[1]
    out = []
    per = max(1, (1 << 28) // max(1, 12 * centers.shape[1] * n))
    for lo in range(0, centers.shape[0], per):
        in_radius = sqdist(centers[lo: lo + per], points[lo: lo + per]) < radius * radius
        ids = torch.arange(n, device=points.device)
        key = torch.where(in_radius, ids, n + ids)
        order = torch.sort(key, dim=-1, stable=True).values[..., :nsample] % n
        hit = torch.gather(in_radius, -1, order)
        idx = torch.where(hit, order, order[..., :1])
        out.append(torch.where(in_radius.any(dim=-1, keepdim=True), idx, 0))
    return torch.cat(out)


# -------------------------------------------------------------- quaternions


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_apply(q: torch.Tensor, t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R(q) p + t`` over ``points (B, N, 3)`` for unit ``q (B, 4)``."""
    qw, qv = q[..., None, 0:1], q[..., None, 1:4]
    qv, pts = torch.broadcast_tensors(qv, points)
    t2 = 2.0 * torch.linalg.cross(qv, pts, dim=-1)
    return pts + qw * t2 + torch.linalg.cross(qv, t2, dim=-1) + t[..., None, :]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = quat_normalize(q).unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def params_to_pose(params: torch.Tensor) -> torch.Tensor:
    """``(..., 7)`` = (t, q_wxyz) → ``(..., 4, 4)``."""
    out = torch.zeros(params.shape[:-1] + (4, 4), dtype=params.dtype, device=params.device)
    out[..., :3, :3] = quat_to_mat(params[..., 3:])
    out[..., :3, 3] = params[..., :3]
    out[..., 3, 3] = 1.0
    return out
