"""Compare two casts of the same rays: the borderline-ray rule.

Two raycasters that round otherwise (XLA on the CPU and PyTorch, or the CPU
and the card) may disagree at a ray that lies on a boundary of the hit test:
near a rectangle's edge, near ``t_min`` / ``t_max``, grazing a plane, or
where two rectangles lie at the same range (a shared edge). Anywhere else
they must agree exactly: the same rectangle, or none, at the same range.
:func:`cast_differences` finds every ray where two casts differ and says of
each whether it is such a borderline ray, from the rays' geometry in float64.

numpy only, so that the CPU tests and ``chip_smoke.py`` share it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# how close to a boundary a ray may lie and still round to either side: a
# share of the magnitudes the float32 arithmetic adds (~170 float32 ulp), or,
# for a plane, a denominator inside the rounding noise of a three-term dot
REL = 1e-5
GRAZING = 1e-6


def _geometry(soa, rect: np.ndarray, pose: np.ndarray, dirs: np.ndarray) -> Dict[str, np.ndarray]:
    """The hit test's quantities of ray ``n`` against rectangle ``rect[n]``
    in float64, with the scale each is rounded at."""
    rot = np.asarray(pose, np.float32)[:3, :3].astype(np.float64)
    origin = np.asarray(pose, np.float32)[:3, 3].astype(np.float64)
    d = np.asarray(dirs, np.float32).astype(np.float64) @ rot.T
    o = soa.origin[rect].astype(np.float64)
    u, v = soa.u[rect].astype(np.float64), soa.v[rect].astype(np.float64)
    nr = soa.normal[rect].astype(np.float64)
    rel0 = o - origin
    denom = np.sum(d * nr, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.sum(rel0 * nr, -1) / denom
    ou, ov = -np.sum(rel0 * u, -1), -np.sum(rel0 * v, -1)
    du, dv = np.sum(d * u, -1), np.sum(d * v, -1)
    uu, vv = soa.uu[rect].astype(np.float64), soa.vv[rect].astype(np.float64)
    return {
        "denom": denom, "t": t,
        "a": (ou + t * du) / uu, "a_scale": (np.abs(ou) + np.abs(t * du)) / uu,
        "b": (ov + t * dv) / vv, "b_scale": (np.abs(ov) + np.abs(t * dv)) / vv,
    }


def _near_boundary(g: Dict[str, np.ndarray], t_min: float, t_max: float) -> Dict[str, np.ndarray]:
    """Per ray, which boundary of the hit test it lies on, if any."""
    edge = np.zeros(len(g["t"]), bool)
    for c in ("a", "b"):
        tol = REL * g[f"{c}_scale"] + 1e-7
        edge |= (np.abs(g[c]) <= tol) | (np.abs(g[c] - 1.0) <= tol)
    t = np.abs(g["t"])
    limit = (np.abs(t - t_min) <= REL * t) | (np.abs(t - t_max) <= REL * t)
    return {"edge": edge, "range_limit": limit, "grazing": np.abs(g["denom"]) <= GRAZING}


def cast_differences(soa, poses: np.ndarray, dirs: np.ndarray, ranges_a: np.ndarray,
                     idx_a: np.ndarray, ranges_b: np.ndarray, idx_b: np.ndarray,
                     t_min: float = 1.5, t_max: float = 80.0) -> dict:
    """Where two casts ``(T, N)`` of ``dirs`` from ``poses`` over the
    rectangles of ``soa`` (a ``RectSoA``) differ, and of what kind.

    Returns ``{"rays", "differing", "hit_vs_miss", "other_rect", "same_rect_range",
    "borderline": {"edge", "range_limit", "grazing", "tie"}, "unexplained"}``:
    counts of rays. A ray counts as borderline if a rectangle that either
    cast names lies on a boundary of the hit test, or if the two casts name
    two rectangles at the same range. ``unexplained`` counts the differing
    rays that are not borderline; ``same_rect_range`` (the same rectangle at
    another range) is always unexplained.
    """
    hit_a, hit_b = np.isfinite(ranges_a), np.isfinite(ranges_b)
    same_range = (ranges_a == ranges_b) | (~hit_a & ~hit_b)
    differ = (idx_a != idx_b) | ~same_range
    out = {"rays": int(differ.size), "differing": int(differ.sum()),
           "hit_vs_miss": int((hit_a != hit_b).sum()),
           "other_rect": int(((idx_a != idx_b) & hit_a & hit_b).sum()),
           "same_rect_range": int(((idx_a == idx_b) & ~same_range).sum()),
           "borderline": {"edge": 0, "range_limit": 0, "grazing": 0, "tie": 0},
           "unexplained": 0}
    for f in range(differ.shape[0]):
        rays = np.nonzero(differ[f])[0]
        if rays.size == 0:
            continue
        borderline = np.zeros(rays.size, bool)
        kinds = {k: np.zeros(rays.size, bool) for k in out["borderline"]}
        for idx in (idx_a[f, rays], idx_b[f, rays]):
            named = (idx >= 0) & (idx_a[f, rays] != idx_b[f, rays])
            if not named.any():
                continue
            g = _geometry(soa, np.where(named, idx, 0), poses[f], dirs[rays])
            for k, near in _near_boundary(g, t_min, t_max).items():
                kinds[k] |= named & near
        both = hit_a[f, rays] & hit_b[f, rays] & (idx_a[f, rays] != idx_b[f, rays])
        ra, rb = ranges_a[f, rays], ranges_b[f, rays]
        with np.errstate(invalid="ignore"):
            kinds["tie"] |= both & (np.abs(ra - rb) <= REL * np.abs(ra))
        for k, v in kinds.items():
            out["borderline"][k] += int(v.sum())
            borderline |= v
        out["unexplained"] += int((~borderline).sum())
    return out
