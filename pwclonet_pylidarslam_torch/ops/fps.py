"""Furthest point sampling, fixed-shape and masked.

Semantics of the reference (``pwclonet_pylidarslam_tpu/ops/fps.py``):

- ``mask (B, N)``, 1 = selectable, defaults to the padding guard
  ``x*x + y*y + z*z > 1e-3``;
- sample 0 is the first valid point (point 0 when none is valid);
- the running distance starts at ``+1e10`` for valid points and ``-1e10``
  for invalid ones, so an invalid point is never picked while a valid one
  is left; with fewer valid points than ``npoint`` picks repeat;
- each step takes the argmax, ties to the lowest index.

On a CUDA tensor :func:`furthest_point_sample` launches the kernel of
``csrc/fps.cu``; on a CPU tensor it runs :func:`furthest_point_sample_plain`,
which the kernel is held against bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.utils.timer import span

_PAD_NORM_SQ = 1e-3
_BIG = 1e10
MAX_POINTS_CUDA = 16 * 1024  # <= 16 points a thread, and N * 12 bytes of shared memory a block


def _sqnorm(x, y, z):
    # written out so that it rounds as the kernel and the reference do
    return x * x + y * y + z * z


def furthest_point_sample_plain(
    points: torch.Tensor, npoint: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch FPS: ``points (B, N, 3)`` → indices ``(B, npoint)`` int32."""
    b = points.shape[0]
    x, y, z = points.unbind(-1)
    valid = _sqnorm(x, y, z) > _PAD_NORM_SQ if mask is None else mask > 0
    big = torch.tensor(_BIG, dtype=points.dtype, device=points.device)
    dist = torch.where(valid, big, -big)
    last = torch.argmax(dist, dim=-1)  # first valid point, else 0
    out = torch.empty((b, npoint), dtype=torch.long, device=points.device)
    out[:, 0] = last
    rows = torch.arange(b, device=points.device)
    for i in range(1, npoint):
        lp = points[rows, last]  # (B, 3)
        d = _sqnorm(x - lp[:, 0:1], y - lp[:, 1:2], z - lp[:, 2:3])
        dist = torch.minimum(dist, torch.where(valid, d, -big))
        last = torch.argmax(dist, dim=-1)
        out[:, i] = last
    return out.to(torch.int32)


def _furthest_point_sample_cuda(
    points: torch.Tensor, npoint: int, mask: Optional[torch.Tensor],
    cluster: int = 0, threads: int = 0, skeleton: bool = False,
) -> torch.Tensor:
    """The kernel. ``cluster`` (blocks a sample) and ``threads`` (a sample) are
    0 for the kernel's own choice, which is what :func:`furthest_point_sample`
    passes; other values are there to be timed against it. ``skeleton`` runs
    the step's key reduction and wait without the distance update (every pick
    is the first one): the floor of the chain of ``npoint`` dependent steps."""
    _cuda.check_cuda_tensor("points", points, (torch.float32,), 3)
    b, n, c = points.shape
    if c != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if not 1 <= n <= MAX_POINTS_CUDA:
        raise ValueError(f"the FPS kernel takes 1 <= N <= {MAX_POINTS_CUDA}, got N={n}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1, got {npoint}")
    mask_ptr = None
    if mask is not None:
        _cuda.check_cuda_tensor("mask", mask, (torch.float32,), 2)
        if tuple(mask.shape) != (b, n) or mask.device != points.device:
            raise ValueError(f"mask must be (B, N) = {(b, n)} on {points.device}")
        mask_ptr = mask.data_ptr()
    out = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    _cuda.launch(
        "fps", "pwclo_fps", points.device,
        points.data_ptr(), mask_ptr, b, n, npoint, out.data_ptr(), cluster, threads,
        int(skeleton), _cuda.stream_of(points),
    )
    return out


@span("op.fps")
@torch.no_grad()
def furthest_point_sample(
    points: torch.Tensor, npoint: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Iterative FPS over ``points (B, N, 3)`` → indices ``(B, npoint)`` int32,
    computed under ``torch.no_grad()``.

    CPU tensors take the plain version; CUDA tensors take the kernel, which
    raises on a shape or dtype it does not take.
    """
    if points.device.type == "cpu":
        return furthest_point_sample_plain(points, npoint, mask)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    return _furthest_point_sample_cuda(points.contiguous(), npoint, mask)
