"""Rigid registration: Kabsch/Procrustes, BEV elevation images, FFT planar
registration.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/registration.py``:
phase correlation of BEV elevation images for (x, y) and correlation of
polar spectra for yaw, on ``torch.fft``. The BEV functions take leading
batch axes (one registration a row), as the reference's take ``vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core import se3


def weighted_procrustes(
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Optimal rigid transform ``T`` with ``T·source ≈ target`` (Kabsch/SVD).

    ``source/target (..., N, 3)``, ``weights (..., N)`` → ``(..., 4, 4)``.
    """
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    w = weights / torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), 1e-12)
    mu_s = torch.sum(source * w[..., None], dim=-2)
    mu_t = torch.sum(target * w[..., None], dim=-2)
    sc = source - mu_s[..., None, :]
    tc = target - mu_t[..., None, :]
    cov = torch.sum(tc[..., :, :, None] * w[..., :, None, None] * sc[..., :, None, :], dim=-3)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = (u * d[..., None, :]) @ vt
    t = mu_t - torch.sum(r * mu_s[..., None, :], dim=-1)
    return se3.make_pose(r, t)


@dataclasses.dataclass(frozen=True)
class BEVConfig:
    pixel_size: float = 0.5  # meters / pixel
    image_size: int = 256  # H = W
    z_min: float = -3.0
    z_max: float = 5.0


def build_elevation_image(
    points: torch.Tensor, config: BEVConfig, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Scatter-max elevation image ``(..., S, S)`` of ``points (..., N, 3)``.

    A pixel holds the max z (clipped to [z_min, z_max]) normalised to
    [0, 1]; empty pixels are 0. The image is centred at the origin.
    """
    s = config.image_size
    px = torch.round(points[..., 0] / config.pixel_size + s // 2).to(torch.int64)
    py = torch.round(points[..., 1] / config.pixel_size + s // 2).to(torch.int64)
    valid = (px >= 0) & (px < s) & (py >= 0) & (py < s)
    valid = valid & (torch.linalg.norm(points, dim=-1) > 1e-6)
    if mask is not None:
        valid = valid & (mask > 0)
    z = torch.clamp(points[..., 2], config.z_min, config.z_max)
    z01 = (z - config.z_min) / (config.z_max - config.z_min)
    flat = torch.where(valid, px * s + py, s * s)
    lead = points.shape[:-2]
    img = torch.zeros(lead + (s * s + 1,), dtype=points.dtype, device=points.device)
    img.scatter_reduce_(-1, flat, torch.where(valid, z01, 0.0), "amax", include_self=True)
    return img[..., : s * s].reshape(lead + (s, s))


class PlanarRegistration(NamedTuple):
    yaw: torch.Tensor  # (...) rad, rotation of b's frame against a's
    translation: torch.Tensor  # (..., 2) meters, in a's frame
    confidence: torch.Tensor  # (...) correlation peak ratio


def _hann2d(s: int, dtype, device) -> torch.Tensor:
    w = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(s, dtype=dtype, device=device) / s)
    return w[:, None] * w[None, :]


def _phase_correlate(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift ``(..., 2)`` in pixels that best maps ``b`` onto ``a``, and
    the sharpness of the correlation peak."""
    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    cross = fa * torch.conj(fb)
    r = cross / torch.clamp_min(torch.abs(cross), 1e-12)
    s0, s1 = a.shape[-2:]
    corr = torch.fft.irfft2(r, s=(s0, s1)).flatten(-2)
    idx = torch.argmax(corr, dim=-1)
    di, dj = idx // s1, idx % s1
    di = torch.where(di > s0 // 2, di - s0, di)
    dj = torch.where(dj > s1 // 2, dj - s1, dj)
    peak = torch.amax(corr, dim=-1)
    conf = peak / torch.clamp_min(torch.mean(torch.abs(corr), dim=-1) * 10.0, 1e-12)
    return torch.stack([di, dj], -1).to(a.dtype), torch.clamp_max(conf, 100.0) * (peak > 0)


@functools.lru_cache(maxsize=8)
def _log_polar_taps(s: int, n_theta: int, n_r: int, device: torch.device):
    """The four bilinear taps of the (theta, log-r) grid on an ``s × s``
    spectrum: per tap, the flat index (clamped into the image), whether it
    lies inside (off-image taps read 0), and its float64 weight. Built on
    the host and uploaded once per size and device."""
    c = s / 2.0
    theta = np.linspace(0.0, np.pi, n_theta, endpoint=False)
    r = np.exp(np.linspace(np.log(2.0), np.log(s / 2.0 - 1), n_r))
    tt, rr = np.meshgrid(theta, r, indexing="ij")
    coords = (c + rr * np.cos(tt), c + rr * np.sin(tt))
    nodes = []
    for x in coords:
        lower = np.floor(x)
        upper_w = x - lower
        index = lower.astype(np.int64)
        nodes.append([(index, 1 - upper_w), (index + 1, upper_w)])
    taps = []
    for (i0, w0) in nodes[0]:
        for (i1, w1) in nodes[1]:
            inside = (i0 >= 0) & (i0 < s) & (i1 >= 0) & (i1 < s)
            flat = np.clip(i0, 0, s - 1) * s + np.clip(i1, 0, s - 1)
            taps.append(tuple(torch.from_numpy(a).to(device) for a in (flat, inside, w0 * w1)))
    return taps


def _log_polar_spectrum(img: torch.Tensor, n_theta: int = 180, n_r: int = 96) -> torch.Tensor:
    """Magnitude spectrum resampled on a (theta, log-r) grid, so that a
    rotation becomes a circular shift along theta. Bilinear, with zeros off
    the image (``map_coordinates(order=1, mode="constant")``); the taps are
    weighted and summed in float64."""
    s = img.shape[-1]
    spec = torch.log1p(torch.abs(torch.fft.fftshift(torch.fft.fft2(img), dim=(-2, -1))))
    flat_spec = spec.flatten(-2).to(torch.float64)
    out = None
    for idx, ok, w in _log_polar_taps(s, n_theta, n_r, img.device):
        term = w * torch.where(ok, flat_spec[..., idx], 0.0)
        out = term if out is None else out + term
    return out.to(img.dtype)


def estimate_yaw(a: torch.Tensor, b: torch.Tensor, n_theta: int = 180):
    """Yaw of ``b`` against ``a`` from polar spectra (the ± π ambiguity is
    resolved by the caller on correlation scores)."""
    pa = _log_polar_spectrum(a, n_theta)
    pb = _log_polar_spectrum(b, n_theta)
    fa = torch.fft.rfft(pa, dim=-2)
    fb = torch.fft.rfft(pb, dim=-2)
    corr = torch.fft.irfft(fa * torch.conj(fb), n=n_theta, dim=-2).sum(dim=-1)
    shift = torch.argmax(corr, dim=-1)
    shift = torch.where(shift > n_theta // 2, shift - n_theta, shift)
    yaw = shift.to(a.dtype) * (math.pi / n_theta)
    conf = torch.amax(corr, dim=-1) / torch.clamp_min(torch.mean(torch.abs(corr), dim=-1), 1e-12)
    return yaw, conf


def rotate_points_z(points: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """``points (..., N, 3)`` turned by ``yaw (...)`` about z."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x = c * points[..., 0] - s * points[..., 1]
    y = s * points[..., 0] + c * points[..., 1]
    return torch.stack([x, y, points[..., 2]], dim=-1)


def register_bev(
    points_a: torch.Tensor,
    mask_a: torch.Tensor,
    points_b: torch.Tensor,
    mask_b: torch.Tensor,
    config: BEVConfig = BEVConfig(),
) -> PlanarRegistration:
    """Planar registration of two local clouds by BEV spectral matching.

    Returns (yaw, txy, confidence) with ``p_a ≈ Rz(yaw)·p_b + t``. Both
    hypotheses of the polar spectrum's π ambiguity are scored by phase
    correlation, and the stronger peak wins.
    """
    img_a = build_elevation_image(points_a, config, mask_a)
    win = _hann2d(config.image_size, img_a.dtype, img_a.device)
    img_a = img_a * win
    yaw0, _ = estimate_yaw(img_a, build_elevation_image(points_b, config, mask_b) * win)

    def score(yaw):
        img_b = build_elevation_image(rotate_points_z(points_b, yaw), config, mask_b)
        return _phase_correlate(img_a, img_b * win)

    s0, c0 = score(yaw0)
    s1, c1 = score(yaw0 + math.pi)
    use1 = c1 > c0
    yaw = torch.where(use1, yaw0 + math.pi, yaw0)
    shift = torch.where(use1[..., None], s1, s0)
    conf = torch.maximum(c0, c1)
    return PlanarRegistration(yaw=yaw, translation=shift * config.pixel_size, confidence=conf)


def planar_to_pose(reg: PlanarRegistration, dtype=torch.float32) -> torch.Tensor:
    """(yaw, txy) → ``(..., 4, 4)`` SE(3) with ``p_a ≈ T · p_b``."""
    c, s = torch.cos(reg.yaw).to(dtype), torch.sin(reg.yaw).to(dtype)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    r = torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    t = torch.stack([reg.translation[..., 0].to(dtype), reg.translation[..., 1].to(dtype),
                     zero], -1)
    return se3.make_pose(r, t)
