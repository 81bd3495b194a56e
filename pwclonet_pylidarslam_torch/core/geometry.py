"""Vertex-map geometry: normal maps, projective neighbourhoods, timestamps.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/geometry.py``.
Vertex maps are channel-last ``(B, H, W, C)`` with xyz in channels 0..2 and
zeros marking empty pixels (see ``core/projection.py``).

No function here multiplies through a matmul or a convolution: the box sum
adds shifted slices and the small contractions are elementwise products and
sums, so cuBLAS's and cuDNN's TF32 switches cannot touch them. At 80 m the
window moments ``Σ p pᵀ`` reach ~1.6e5, and TF32's 10-bit mantissa would
wreck the normals.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def box_filter_sum(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Channel-wise K×K box sum of ``(B, H, W, C)`` with zero padding.

    The K² shifted slices of the padded map are added in row-major window
    order, the order of XLA's ``reduce_window`` on the CPU: the sums are
    bit-equal to the reference's there. The window moments of
    :func:`compute_normal_map` are ill-conditioned enough that another
    order of addition moves normals by ~1e-2.
    """
    pad = kernel_size // 2
    b, h, w, c = img.shape
    out_h, out_w = h + 2 * pad - kernel_size + 1, w + 2 * pad - kernel_size + 1
    padded = F.pad(img, (0, 0, pad, pad, pad, pad))
    out = None
    for i in range(kernel_size):
        for j in range(kernel_size):
            tap = padded[:, i:i + out_h, j:j + out_w]
            out = tap if out is None else out + tap
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to the dtype of ``c``: the product of two
    float32 values is exact in float64, where the add is taken."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(c.dtype)


def _inverse3x3(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form adjugate inverse of ``(..., 3, 3)`` and its determinant.

    A singular matrix gives a meaningless inverse and |det| ≈ 0; callers
    mask on the determinant. The window moments of a normal map are nearly
    singular, so the cofactors cancel heavily; each is taken as XLA's CPU
    compiler contracts the reference's expression, ``p·q − r·s`` as
    ``fma(p, q, −r·s)``, and the determinant as
    ``fma(a02, c02, fma(a00, c00, a01·c01))``. A plain evaluation moves the
    normals by up to ~1e-2 from the reference's.
    """
    a = m

    def cof(i0, j0, i1, j1, i2, j2, i3, j3):
        return _fma(a[..., i0, j0], a[..., i1, j1], -(a[..., i2, j2] * a[..., i3, j3]))

    c00 = cof(1, 1, 2, 2, 1, 2, 2, 1)
    c01 = cof(1, 2, 2, 0, 1, 0, 2, 2)
    c02 = cof(1, 0, 2, 1, 1, 1, 2, 0)
    c10 = cof(0, 2, 2, 1, 0, 1, 2, 2)
    c11 = cof(0, 0, 2, 2, 0, 2, 2, 0)
    c12 = cof(0, 1, 2, 0, 0, 0, 2, 1)
    c20 = cof(0, 1, 1, 2, 0, 2, 1, 1)
    c21 = cof(0, 2, 1, 0, 0, 0, 1, 2)
    c22 = cof(0, 0, 1, 1, 0, 1, 1, 0)
    det = _fma(a[..., 0, 2], c02, _fma(a[..., 0, 0], c00, a[..., 0, 1] * c01))
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    safe_det = torch.where(torch.abs(det) > 1e-12, det, 1.0)
    return adj / safe_det[..., None, None], det


def _fused_dot3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Σ_j a[..., i, j] v[..., j]`` as XLA's CPU dot adds it: a chain of
    fused multiply-adds in ``j`` order (``M⁻¹ S`` cancels heavily too)."""
    acc = a[..., 0] * v[..., None, 0]
    for j in range(1, a.shape[-1]):
        acc = _fma(a[..., j], v[..., None, j], acc)
    return acc


def compute_normal_map(vertex_map: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Per-pixel surface normals of a vertex map ``(B, H, W, 3)``.

    With box sums ``S = Σ p`` and ``M = Σ p pᵀ`` over the K×K window (empty
    pixels are zero and drop out), the plane ``n·x = 1`` through the window
    solves ``M n = S``; the normal is ``normalize(M⁻¹ S)``. Pixels with
    ``|det M| ≤ 1e-6`` or an empty centre get a zero normal.
    """
    xyz = vertex_map[..., :3]
    b, h, w = xyz.shape[:3]
    outer = xyz[..., :, None] * xyz[..., None, :]
    m = box_filter_sum(outer.reshape(b, h, w, 9), kernel_size).reshape(b, h, w, 3, 3)
    s = box_filter_sum(xyz, kernel_size)
    inv, det = _inverse3x3(m)
    n = _fused_dot3(inv, s)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm > 0, norm, 1.0)
    valid_center = torch.linalg.norm(xyz, dim=-1, keepdim=True) > 0
    well_posed = (torch.abs(det) > 1e-6)[..., None] & (norm > 0)
    return torch.where(valid_center & well_posed, n, 0.0)


def orient_normals_towards_origin(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Flip normals to face the sensor (dot(n, p) ≤ 0)."""
    flip = torch.sum(points * normals, dim=-1, keepdim=True) > 0
    return torch.where(flip, -normals, normals)


def compute_neighbors(
    vm_target: torch.Tensor,
    vm_reference: torch.Tensor,
    reference_fields: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Projective nearest neighbour across a stack of reference maps.

    ``vm_target (B, H, W, 3)`` against ``vm_reference (D, H, W, 3)`` on the
    same pixel grid: for each target pixel, the closest of the D reference
    points at that pixel (the first on ties). Empty pixels on either side
    are excluded; targets with no candidate get zeros.
    ``reference_fields (D, H, W, C)`` rides along through the same choice.
    """
    t_valid = torch.linalg.norm(vm_target[..., :3], dim=-1) > 0
    r_valid = torch.linalg.norm(vm_reference[..., :3], dim=-1) > 0
    diff = torch.linalg.norm(vm_target[:, None, ..., :3] - vm_reference[None, ..., :3], dim=-1)
    diff = torch.where(r_valid[None], diff, math.inf)  # (B, D, H, W)
    best = torch.argmin(diff, dim=1)  # (B, H, W)
    any_valid = torch.isfinite(torch.amin(diff, dim=1)) & t_valid

    def pick(ref: torch.Tensor) -> torch.Tensor:
        d, h, w, c = ref.shape
        src = ref.permute(1, 2, 0, 3).reshape(1, h * w, d, c).expand(best.shape[0], -1, -1, -1)
        idx = best.reshape(-1, h * w, 1, 1).expand(-1, -1, 1, c)
        out = torch.gather(src, 2, idx).reshape(-1, h, w, c)
        return torch.where(any_valid[..., None], out, 0.0)

    nbrs = pick(vm_reference)
    fields = None if reference_fields is None else pick(reference_fields)
    return nbrs, fields


def estimate_timestamps(points: torch.Tensor, clockwise: bool = True) -> torch.Tensor:
    """Per-point acquisition fraction in [0, 1] from azimuth (0 = scan
    start, the azimuth π behind x; 1 = end)."""
    phi = torch.atan2(points[..., 1], points[..., 0])
    if clockwise:
        frac = (math.pi - phi) / (2.0 * math.pi)
    else:
        frac = (phi + math.pi) / (2.0 * math.pi)
    return torch.clamp(frac, 0.0, 1.0)


def pixel_grid(height: int, width: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(H, W, 2)`` grid of (row, col) coordinates."""
    rows = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    cols = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    return torch.stack([rows, cols], dim=-1)
