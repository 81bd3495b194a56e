"""Robust weighted least squares and batched Gauss-Newton.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/optimization.py``.
Weights follow ``w(r) = sqrt(C(r)) / clamp(|r|, eps)``, so that the weighted
residual ``w·r`` squared is the robust cost. The SE(3) solver updates
``pose ← exp(δ)·pose`` with the analytic left-perturbation jacobians of the
point-to-plane and point-to-point residuals.

The iteration stops at convergence like the reference's
``lax.while_loop``: the loop runs on the host and reads the convergence
flags back once an iteration. Every 6×6 solve goes through
``torch.linalg.solve_ex(..., check_errors=False)``: no host read, and a
singular system gives non-finite values as in JAX instead of raising.

A robust scale given as a ``numpy.float32`` is squared in float32, as the
reference squares its float32 ``sigma`` arrays; a Python float is squared in
double, as JAX does with a weakly typed scalar.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from pwclonet_pylidarslam_torch.core import se3
from pwclonet_pylidarslam_torch.core.rotation import hat

LS_SCHEMES = (
    "least_square",
    "huber",
    "exp",
    "neighborhood",
    "geman_mcclure",
    "square_geman_mcclure",
    "cauchy",
)


def robust_cost(
    residuals: torch.Tensor,
    scheme: str = "least_square",
    sigma: float = 0.5,
    match_distances: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-residual robust cost ``C(r)``."""
    r2 = residuals * residuals
    if scheme in ("least_square", "default"):
        return r2
    s2 = float(sigma * sigma)
    s = float(sigma)
    if scheme == "huber":
        abs_r = torch.abs(residuals)
        return torch.where(abs_r < s, r2, 2.0 * s * abs_r - s2)
    if scheme == "exp":
        return r2 * torch.exp(-r2 / s2)
    if scheme == "neighborhood":
        if match_distances is None:
            raise ValueError("neighborhood scheme requires match_distances")
        return r2 * torch.exp(-(match_distances**2) / s2)
    if scheme == "geman_mcclure":
        return s * r2 / (s + r2)
    if scheme == "square_geman_mcclure":
        return r2 * (s / (s + r2)) ** 2
    if scheme == "cauchy":
        return torch.log1p(r2 / s2)
    raise ValueError(f"unknown scheme {scheme!r}; choose from {LS_SCHEMES}")


def robust_weights(
    residuals: torch.Tensor,
    scheme: str = "least_square",
    sigma: float = 0.5,
    eps: float = 1e-4,
    match_distances: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IRLS attenuation ``w(r) = sqrt(C(r)) / clamp(|r|, eps)``."""
    if scheme in ("least_square", "default"):
        return torch.ones_like(residuals)
    cost = robust_cost(residuals, scheme, sigma, match_distances)
    return torch.sqrt(torch.clamp_min(cost, 0.0)) / torch.clamp_min(torch.abs(residuals), eps)


def normal_equations(wjac: torch.Tensor, wres: torch.Tensor):
    """``H = JᵀJ (B, D, D)`` and ``g = Jᵀr (B, D)`` of weighted ``wjac
    (B, N, D)`` and ``wres (B, N)``. ``g`` is taken as ``rᵀJ``: on the CPU
    that product rounds each row as it would alone whatever B, where ``Jᵀr``
    rounds otherwise once B > 1 (at B = 1 the two are equal)."""
    h = wjac.transpose(-1, -2) @ wjac
    g = (wres[..., None, :] @ wjac)[..., 0, :]
    return h, g


def damped_step(h: torch.Tensor, g: torch.Tensor, damping: float = 1e-9) -> torch.Tensor:
    """``-(H + λI)⁻¹ g`` with ``λ = damping · (trace(H)/D + 1)``, batched."""
    d = h.shape[-1]
    lam = damping * (torch.diagonal(h, dim1=-2, dim2=-1).sum(-1) / d + 1.0)
    eye = torch.eye(d, dtype=h.dtype, device=h.device)
    sol, _ = torch.linalg.solve_ex(h + lam[..., None, None] * eye, g[..., None],
                                   check_errors=False)
    return -sol[..., 0]


class GNResult(NamedTuple):
    x: torch.Tensor  # (B, D) optimized parameters
    cost: torch.Tensor  # (B,) final sum of squared weighted residuals
    num_iters: torch.Tensor  # (B,) iterations run
    converged: torch.Tensor  # (B,) step-norm criterion hit


def gauss_newton(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    jac_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_iters: int = 10,
    norm_stop_criterion: float = 1e-3,
    scheme: str = "least_square",
    sigma: float = 0.5,
    eps: float = 1e-4,
    damping: float = 1e-9,
    match_distances: Optional[torch.Tensor] = None,
) -> GNResult:
    """Batched additive Gauss-Newton over ``x0 (B, D)``.

    ``residual_fn(x) -> (B, N)``; ``jac_fn(x) -> (B, N, D)`` defaults to
    forward-mode autodiff per batch element. Convergence is tracked per
    batch element; the loop ends when every element's step norm fell below
    ``norm_stop_criterion`` or after ``max_iters``.
    """
    if jac_fn is None:
        jac_fn = torch.func.vmap(torch.func.jacfwd(lambda x: residual_fn(x[None])[0]))
    x = x0
    converged = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
    it = 0
    while it < max_iters:
        res = residual_fn(x)
        jac = jac_fn(x)
        w = robust_weights(res, scheme, sigma, eps, match_distances)
        h, g = normal_equations(jac * w[..., None], res * w)
        dx = damped_step(h, g, damping)
        x = x + torch.where(converged[..., None], 0.0, dx)
        converged = converged | (torch.linalg.norm(dx, dim=-1) < norm_stop_criterion)
        it += 1
        if bool(converged.all()):
            break
    res = residual_fn(x)
    w = robust_weights(res, scheme, sigma, eps, match_distances)
    cost = torch.sum((res * w) ** 2, dim=-1)
    iters = torch.full((x0.shape[0],), it, dtype=torch.int32, device=x0.device)
    return GNResult(x=x, cost=cost, num_iters=iters, converged=converged)


class SE3GNResult(NamedTuple):
    pose: torch.Tensor  # (B, 4, 4) optimized pose
    cost: torch.Tensor  # (B,) final sum of squared weighted residuals
    num_iters: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


def point_to_plane_residual_jac(
    pose: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """Residuals and left-perturbation jacobian of the point-to-plane objective.

    ``r_i = n_i · (T·p_i − q_i)`` for source ``p (B,N,3)``, target
    ``q (B,N,3)``, normals ``n (B,N,3)`` and pose ``T (B,4,4)``; with
    ``p' = T·p``, ``∂r/∂δ = [ n_iᵀ , (p'_i × n_i)ᵀ ]`` (twist layout (v, ω)).
    Masked correspondences are zeroed and drop out of H and g.
    """
    p = se3.transform(pose, source)
    res = torch.sum(normals * (p - target), dim=-1)
    jac = torch.cat([normals, torch.linalg.cross(p, normals, dim=-1)], dim=-1)
    if mask is not None:
        res = res * mask
        jac = jac * mask[..., None]
    return res, jac


def point_to_point_residual_jac(
    pose: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """Residuals and jacobian of ``r = exp(δ)·T·p − q`` at ``δ = 0``,
    flattened to 3N rows: ``∂(exp(δ)p')/∂δ = [ I | −[p']ₓ ]``."""
    b, n, _ = source.shape
    p = se3.transform(pose, source)
    res3 = p - target
    eye = torch.eye(3, dtype=source.dtype, device=source.device).expand(b, n, 3, 3)
    jac3 = torch.cat([eye, -hat(p)], dim=-1)
    if mask is not None:
        res3 = res3 * mask[..., None]
        jac3 = jac3 * mask[..., None, None]
    return res3.reshape(b, n * 3), jac3.reshape(b, n * 3, 6)


def gauss_newton_se3(
    residual_jac_fn: Callable[[torch.Tensor], tuple],
    init_pose: torch.Tensor,
    max_iters: int = 10,
    norm_stop_criterion: float = 1e-3,
    scheme: str = "least_square",
    sigma: float = 0.5,
    eps: float = 1e-4,
    damping: float = 1e-9,
    match_distances: Optional[torch.Tensor] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> SE3GNResult:
    """Gauss-Newton on SE(3) with multiplicative updates.

    ``residual_jac_fn(pose) -> (res (B,N), jac (B,N,6))``, the jacobian
    taken against a left perturbation ``exp(δ)·pose`` at ``δ = 0``. Each
    iteration solves the damped 6×6 normal equations and sets
    ``pose ← exp(δ)·pose``; a converged problem takes no further step.

    ``reduce``: where the N axis is split over processes, the sum over them
    (an all-reduce, ``parallel/sharded_icp.py``). It is applied to H and g,
    packed as one ``(B, 42)`` tensor, every iteration, and to the final
    cost, the reference's ``psum_axis`` sites; every rank then solves the
    same system and reads the same convergence flags. The robust weights
    stay per point. Without it nothing is reduced.
    """
    pose = init_pose
    converged = torch.zeros(init_pose.shape[0], dtype=torch.bool, device=init_pose.device)
    it = 0
    while it < max_iters:
        res, jac = residual_jac_fn(pose)
        w = robust_weights(res, scheme, sigma, eps, match_distances)
        h, g = normal_equations(jac * w[..., None], res * w)
        if reduce is not None:
            hg = reduce(torch.cat([h.flatten(-2), g], dim=-1))
            h, g = hg[..., :36].unflatten(-1, (6, 6)), hg[..., 36:]
        dx = torch.where(converged[..., None], 0.0, damped_step(h, g, damping))
        pose = se3.exp(dx) @ pose
        converged = converged | (torch.linalg.norm(dx, dim=-1) < norm_stop_criterion)
        it += 1
        # the flag is read only where it can end the loop early
        if it < max_iters and bool(converged.all()):
            break
    res, _ = residual_jac_fn(pose)
    w = robust_weights(res, scheme, sigma, eps, match_distances)
    cost = torch.sum((res * w) ** 2, dim=-1)
    if reduce is not None:
        cost = reduce(cost)
    iters = torch.full((init_pose.shape[0],), it, dtype=torch.int32, device=init_pose.device)
    return SE3GNResult(pose=pose, cost=cost, num_iters=iters, converged=converged)


def solve_point_to_plane(
    source: torch.Tensor,
    target: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    init_pose: Optional[torch.Tensor] = None,
    **gn_kwargs,
) -> SE3GNResult:
    """The pose that minimises the point-to-plane cost of ``source`` against
    ``target``, batched over the leading axis."""
    if init_pose is None:
        init_pose = se3.identity_pose(source.shape[:-2], source.dtype, source.device)
    fn = functools.partial(
        point_to_plane_residual_jac, source=source, target=target, normals=normals, mask=mask
    )
    return gauss_newton_se3(fn, init_pose, **gn_kwargs)


def solve_point_to_point(
    source: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    init_pose: Optional[torch.Tensor] = None,
    **gn_kwargs,
) -> SE3GNResult:
    """The pose that minimises the point-to-point cost."""
    if init_pose is None:
        init_pose = se3.identity_pose(source.shape[:-2], source.dtype, source.device)
    fn = functools.partial(point_to_point_residual_jac, source=source, target=target, mask=mask)
    return gauss_newton_se3(fn, init_pose, **gn_kwargs)
