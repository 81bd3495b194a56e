"""Synthetic LiDAR sequences: analytic trajectories over a raycast world.

The numpy parts of ``pwclonet_pylidarslam_tpu/data/synthetic.py`` that the
port needs to make scans and training pairs without the JAX package: the
corridor, along-path and KITTI-profile worlds (with their moving traffic),
the numpy raycaster, the sensor model, the trajectories, the sequence
generator, the deep-odometry input filter and the pair dataset. Rigid sweeps
are cast by :class:`FrameRaycaster`, the reference's batched caster, in
PyTorch on the caster's device; its arithmetic follows XLA's on the CPU
(the dot products as chains of fused multiply-adds), so a ray hits the same
rectangle at the same range as the reference's but at a borderline ray.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.data.kitti import pose_to_params, random_augmentation
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.utils.timer import count, span


@dataclasses.dataclass(frozen=True)
class Rect:
    """Finite rectangle: point ``origin``, edge vectors ``u``/``v``, outward normal.

    ``roughness`` is the per-surface extra range-noise sigma in meters —
    e.g. grassy ground returns are several centimeters rougher than building
    facades, a real-KITTI failure mode the flat synthetic world lacked
    (VERDICT round 1, item 1b).
    """

    origin: np.ndarray
    u: np.ndarray
    v: np.ndarray
    roughness: float = 0.0

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.u, self.v)
        return n / np.linalg.norm(n)


def _box(center, size, roughness: float = 0.0) -> List[Rect]:
    """Axis-aligned box as 5 rectangles: four sides and the top (the
    reference's docstring says 6; its list has no bottom face)."""
    cx, cy, cz = center
    sx, sy, sz = np.asarray(size) / 2.0
    ex, ey, ez = np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])
    c = np.asarray(center, np.float64)
    return [
        Rect(c + ex * sx - ey * sy - ez * sz, 2 * sy * ey, 2 * sz * ez, roughness),
        Rect(c - ex * sx - ey * sy - ez * sz, 2 * sz * ez, 2 * sy * ey, roughness),
        Rect(c - ex * sx + ey * sy - ez * sz, 2 * sx * ex, 2 * sz * ez, roughness),
        Rect(c - ex * sx - ey * sy - ez * sz, 2 * sz * ez, 2 * sx * ex, roughness),
        Rect(c - ex * sx - ey * sy + ez * sz, 2 * sx * ex, 2 * sy * ey, roughness),
    ]


@dataclasses.dataclass(frozen=True)
class DynamicBox:
    """A moving box (vehicle/pedestrian): center translates by ``velocity``
    (meters/frame). Dynamic objects violate the static-world assumption every
    SLAM front-end makes — on real KITTI they are the dominant source of
    association outliers, so the hardened world simulates them."""

    center: np.ndarray
    size: np.ndarray
    velocity: np.ndarray
    roughness: float = 0.02

    def rects_at(self, t: int) -> List[Rect]:
        return _box(
            np.asarray(self.center) + np.asarray(self.velocity) * t,
            self.size,
            self.roughness,
        )


def default_world(seed: int = 0) -> List[Rect]:
    """An urban-ish corridor: ground plane plus buildings flanking a street."""
    rng = np.random.default_rng(seed)
    rects = [
        # large ground plane at z = -1.7
        Rect(np.array([-200.0, -200.0, -1.7]), np.array([400.0, 0, 0]), np.array([0, 400.0, 0])),
    ]
    # buildings along both sides of a street running along +x
    for i in range(14):
        x = -40.0 + i * 22.0 + rng.uniform(-3, 3)
        for side in (-1.0, 1.0):
            y = side * (9.0 + rng.uniform(0, 6))
            w = rng.uniform(6, 14)
            d = rng.uniform(4, 8)
            h = rng.uniform(4, 14)
            rects.extend(_box([x, y + side * d / 2, -1.7 + h / 2], [w, d, h]))
    # a few scattered obstacles on the street (parked cars / boxes)
    for _ in range(10):
        x = rng.uniform(-30, 260)
        y = rng.uniform(-6, 6)
        rects.extend(_box([x, y, -1.2], [rng.uniform(1.5, 4), rng.uniform(1.2, 2), 1.4]))
    return rects


def world_along_path(poses: np.ndarray, seed: int = 0) -> List[Rect]:
    """Urban-ish world flanking an arbitrary trajectory.

    ``default_world`` builds a straight corridor along +x; trajectories that
    turn eventually leave it and see nothing but the ground plane. This
    generator places buildings along the *path*: every ~20 m of arc length,
    one box on each side of the local heading, plus scattered street-level
    obstacles.
    """
    rng = np.random.default_rng(seed)
    rects = [
        Rect(
            np.array([-400.0, -400.0, -1.7]),
            np.array([800.0, 0, 0]),
            np.array([0, 800.0, 0]),
        ),
    ]
    positions = poses[:, :3, 3]
    seg = np.linalg.norm(np.diff(positions, axis=0), axis=-1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    next_spawn = -20.0  # also cover the stretch behind the start
    for t in range(len(poses)):
        if arc[t] < next_spawn:
            continue
        next_spawn = arc[t] + 20.0 + rng.uniform(-4, 4)
        heading = poses[t, :3, 0]  # vehicle x = forward
        lateral = poses[t, :3, 1]  # vehicle y = left
        for side in (-1.0, 1.0):
            y_off = side * (9.0 + rng.uniform(0, 6))
            center = (
                positions[t]
                + lateral * y_off
                + heading * rng.uniform(-6, 6)
            )
            w = rng.uniform(6, 14)
            d = rng.uniform(4, 8)
            h = rng.uniform(4, 14)
            rects.extend(_box([center[0], center[1], -1.7 + h / 2], [w, d, h]))
        if rng.uniform() < 0.6:
            obs = positions[t] + lateral * rng.uniform(-6, 6) + heading * rng.uniform(0, 12)
            rects.extend(
                _box([obs[0], obs[1], -1.2], [rng.uniform(1.5, 4), rng.uniform(1.2, 2), 1.4])
            )
    return rects


class RectSoA:
    """Rectangles packed into arrays — raycast vectorizes over rays AND
    rectangles (matrix products instead of a Python loop per rect), with
    bounding-sphere culling so a long world only pays for nearby geometry."""

    def __init__(self, rects: List[Rect]):
        # float32 throughout: the raycast is memory-bound on (N_rays, R)
        # intermediates and centimeter precision is far below sensor noise
        self.origin = np.stack([r.origin for r in rects]).astype(np.float32)
        self.u = np.stack([r.u for r in rects]).astype(np.float32)
        self.v = np.stack([r.v for r in rects]).astype(np.float32)
        self.normal = np.stack([r.normal for r in rects]).astype(np.float32)
        self.uu = np.einsum("rd,rd->r", self.u, self.u)
        self.vv = np.einsum("rd,rd->r", self.v, self.v)
        self.roughness = np.array([r.roughness for r in rects], np.float32)
        self.center = self.origin + 0.5 * self.u + 0.5 * self.v
        self.radius = 0.5 * np.linalg.norm(self.u + self.v, axis=-1)


def raycast_hits(
    soa: RectSoA,
    origin: np.ndarray,
    dirs: np.ndarray,
    t_min: float = 1.5,
    t_max: float = 80.0,
    chunk: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Closest-hit ``(ranges (N,), rect_idx (N,))`` for rays from a single
    ``origin (3,)`` along ``dirs (N,3)``; inf / -1 where nothing is hit.

    Per rect-chunk math avoids materializing any ``(N, R, 3)`` tensor: the
    in-plane coordinates are ``a = (o·u + t·(d·u)) / ‖u‖²`` so everything is
    ``(N, R)`` matrices (ray·edge products).
    """
    origin = np.asarray(origin, np.float32)
    dirs = np.asarray(dirs, np.float32)
    # bounding-sphere cull: a rect can only be hit within t_max of the origin
    near = np.linalg.norm(soa.center - origin, axis=-1) <= t_max + soa.radius
    keep = np.nonzero(near)[0]
    n = dirs.shape[0]
    best = np.full(n, np.inf, np.float32)
    best_idx = np.full(n, -1, np.int64)
    for s in range(0, keep.size, chunk):
        sel = keep[s : s + chunk]
        nr = soa.normal[sel]  # (R,3)
        rel0 = soa.origin[sel] - origin  # (R,3)
        denom = dirs @ nr.T  # (N,R)
        num = np.einsum("rd,rd->r", rel0, nr)  # (R,)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num[None, :] / denom
        du = dirs @ soa.u[sel].T  # (N,R)
        dv = dirs @ soa.v[sel].T
        ou = -np.einsum("rd,rd->r", rel0, soa.u[sel])  # (origin-o_r)·u
        ov = -np.einsum("rd,rd->r", rel0, soa.v[sel])
        a = (ou[None, :] + t * du) / soa.uu[sel][None, :]
        b = (ov[None, :] + t * dv) / soa.vv[sel][None, :]
        ok = (
            (np.abs(denom) > 1e-9)
            & (t > t_min) & (t < t_max)
            & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        )
        t = np.where(ok, t, np.inf)
        j = np.argmin(t, axis=1)
        tj = t[np.arange(n), j]
        better = tj < best
        best = np.where(better, tj, best)
        best_idx = np.where(better, sel[j], best_idx)
    return best, best_idx


# frames × rays × rects per batch of the caster: one (F, N, R) float32 tile
# is 64 MiB (a 64-beam frame is ~15M elements, so a batch is one frame), the
# float64 products of the fused multiply-adds twice that
CAST_TILE_ELEMENTS = 1 << 24


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (the product of two float32 values
    is exact in float64, where the add is taken): a fused multiply-add, as
    XLA's CPU compiler emits the reference's dots and ``c + t·d``."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Σ_k x[..., k]·y[..., k]`` over three terms as XLA's CPU dot adds
    them: ``fma(x2, y2, fma(x1, y1, x0·y0))``. No matmul, so no TF32 either."""
    return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


def _raycast_frames_device(
    rect_arrays, sel, valid, poses, dirs, t_min: float, t_max: float
):
    """Closest hits of a batch of frames on the tensors' device.

    ``rect_arrays``: global packed rects (origin/u/v/normal/uu/vv), float32;
    ``sel (F, R)`` per-frame culled rect indices (padded), ``valid (F, R)``;
    ``poses (F, 4, 4)`` float32; ``dirs (N, 3)`` float32 sensor-frame ray
    directions. Returns ``(ranges (F, N), idx (F, N))``: each ray's
    arithmetic is the reference's ``one_frame`` (``lax.map`` over frames
    there; a batch of frames at once here), ``argmin`` takes the first
    rectangle on ties, and ``idx`` is -1 where nothing is hit.
    """
    g_origin, g_u, g_v, g_normal, g_uu, g_vv = rect_arrays
    origin = poses[:, None, :3, 3]  # (F, 1, 3)
    rot = poses[:, :3, :3]
    o_r, u, v, nr = (g[sel][:, None] for g in (g_origin, g_u, g_v, g_normal))  # (F, 1, R, 3)
    uu, vv = g_uu[sel][:, None], g_vv[sel][:, None]  # (F, 1, R)
    d_world = _dot3(dirs[None, :, None, :], rot[:, None, :, :])[:, :, None, :]  # (F, N, 1, 3)
    rel0 = o_r - origin[:, :, None, :]  # (F, 1, R, 3)
    denom = _dot3(d_world, nr)  # (F, N, R)
    num = _dot3(rel0, nr)  # (F, 1, R)
    t = num / denom
    du = _dot3(d_world, u)
    dv = _dot3(d_world, v)
    ou = -_dot3(rel0, u)
    ov = -_dot3(rel0, v)
    a = _fma(t, du, ou) / uu
    b = _fma(t, dv, ov) / vv
    ok = (
        (torch.abs(denom) > 1e-9)
        & (t > t_min) & (t < t_max)
        & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        & valid[:, None, :]
    )
    t = torch.where(ok, t, torch.inf)
    j = torch.argmin(t, dim=2)
    tb = torch.gather(t, 2, j[..., None])[..., 0]
    idx = torch.where(torch.isfinite(tb), torch.gather(sel, 1, j), -1)
    return tb, idx.to(torch.int32)


class FrameRaycaster:
    """Batched raycaster: per-frame bounding-sphere culling on the host, then
    every frame's full sweep cast on ``device`` in batches of frames.

    The pure-numpy :func:`raycast_hits` runs ~0.3 s/frame for a 64-beam sweep
    on a 2-core host; on the card the same math is a batched multiply-add and
    mask pipeline. Float32 throughout, as the reference's (its ``RectSoA`` is
    float32 and it casts poses and directions to float32).
    """

    def __init__(
        self,
        rects: List[Rect],
        t_min: float = 1.5,
        t_max: float = 80.0,
        n_static: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.soa = RectSoA(rects)
        self.t_min, self.t_max = t_min, t_max
        self.n_static = len(rects) if n_static is None else n_static
        self.device = resolve_device(device)
        self._arrays = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (
                self.soa.origin, self.soa.u, self.soa.v,
                self.soa.normal, self.soa.uu, self.soa.vv,
            )
        )

    def cast_all(
        self, poses: np.ndarray, dirs: np.ndarray, extra_sets=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Ranges + hit rect index for every frame: ``(T, N)`` float32 and
        int32.

        ``extra_sets``: optional per-frame lists of extra rect indices that
        must stay in the frame's working set regardless of culling (used for
        per-frame dynamic-object instances).
        """
        t_frames = poses.shape[0]
        sels = []
        # cull only the static prefix; per-frame extras (dynamic-object
        # instances, already frame-specific) are appended verbatim
        center = self.soa.center[: self.n_static]
        radius = self.soa.radius[: self.n_static]
        for t in range(t_frames):
            origin = poses[t, :3, 3]
            near = np.linalg.norm(center - origin, axis=-1) <= self.t_max + radius
            idx = np.nonzero(near)[0]
            if extra_sets is not None and extra_sets[t] is not None:
                idx = np.concatenate([idx, np.asarray(extra_sets[t], np.int64)])
            sels.append(idx)
        r_max = max(1, max(len(s) for s in sels))
        # the reference rounds up so that small world variations reuse its
        # compiled kernel; kept, so that both cast over the same padding
        r_max = ((r_max + 31) // 32) * 32
        sel = np.zeros((t_frames, r_max), np.int64)
        valid = np.zeros((t_frames, r_max), bool)
        for t, s in enumerate(sels):
            sel[t, : len(s)] = s
            valid[t, : len(s)] = True
        dev = self.device
        sel_d, valid_d = torch.from_numpy(sel).to(dev), torch.from_numpy(valid).to(dev)
        poses_d = torch.from_numpy(np.asarray(poses, np.float32)).to(dev)
        dirs_d = torch.from_numpy(np.asarray(dirs, np.float32)).to(dev)
        # tiles of whole frames, or of rays of one frame where a frame is
        # larger than a tile; every ray's arithmetic is the same in any tile
        n_rays = dirs_d.shape[0]
        tile = CAST_TILE_ELEMENTS
        frames = max(1, tile // (n_rays * r_max))
        rays = min(n_rays, max(1, tile // r_max))
        ranges = torch.empty((t_frames, n_rays), dtype=torch.float32, device=dev)
        hit = torch.empty((t_frames, n_rays), dtype=torch.int32, device=dev)
        for f in range(0, t_frames, frames):
            for n in range(0, n_rays, rays):
                ranges[f : f + frames, n : n + rays], hit[f : f + frames, n : n + rays] = (
                    _raycast_frames_device(
                        self._arrays, sel_d[f : f + frames], valid_d[f : f + frames],
                        poses_d[f : f + frames], dirs_d[n : n + rays], self.t_min, self.t_max,
                    )
                )
        return ranges.cpu().numpy(), hit.cpu().numpy()


def raycast(rects: List[Rect], origins: np.ndarray, dirs: np.ndarray,
            t_min: float = 1.5, t_max: float = 80.0) -> np.ndarray:
    """Closest-hit ranges for rays ``origins (N,3)`` / ``dirs (N,3)``.

    Back-compat wrapper over :func:`raycast_hits` (all origins must be equal,
    which is how every caller uses it — one sensor origin per sweep step).
    Returns ranges with inf where nothing is hit.
    """
    origins = np.asarray(origins)
    if not np.allclose(origins, origins[0]):
        # the single-origin fast path would silently mis-range varying
        # origins — fail loudly instead
        raise ValueError("raycast() requires all ray origins equal; "
                         "use raycast_hits per origin for varying origins")
    ranges, _ = raycast_hits(RectSoA(rects), origins[0], dirs, t_min, t_max)
    return ranges


def kitti_world(
    poses: np.ndarray, seed: int = 0
) -> Tuple[List[Rect], List[DynamicBox]]:
    """Hardened urban world along a trajectory, targeting the real-KITTI
    failure modes the plain corridor world lacks (VERDICT round 1 item 1b):

    - grassy/rough ground (3 cm range roughness vs 1 cm facades);
    - buildings with gaps → occlusion shadows and disocclusions;
    - street furniture: poles, parked cars;
    - **dynamic vehicles** (oncoming + leading traffic) that violate the
      static-world assumption exactly like real traffic does.

    Returns ``(static_rects, dynamic_boxes)``.
    """
    rng = np.random.default_rng(seed)
    positions = poses[:, :3, 3]
    lo = positions.min(axis=0) - 150.0
    hi = positions.max(axis=0) + 150.0
    rects = [
        Rect(
            np.array([lo[0], lo[1], -1.7]),
            np.array([hi[0] - lo[0], 0, 0]),
            np.array([0, hi[1] - lo[1], 0]),
            roughness=0.03,
        ),
    ]

    def clear_of_path(center, size, margin) -> bool:
        """No trajectory position within ``margin`` of the box footprint —
        path turns can sweep into geometry spawned from an earlier heading
        (observed: a facade 1.4 m off the roadway right after the first
        90-degree turn), so the check runs against the WHOLE trajectory."""
        dx = np.maximum(np.abs(positions[:, 0] - center[0]) - size[0] / 2, 0.0)
        dy = np.maximum(np.abs(positions[:, 1] - center[1]) - size[1] / 2, 0.0)
        return float(np.min(np.hypot(dx, dy))) >= margin

    seg = np.linalg.norm(np.diff(positions, axis=0), axis=-1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    dynamics: List[DynamicBox] = []
    next_spawn = -20.0
    for t in range(len(poses)):
        if arc[t] < next_spawn:
            continue
        next_spawn = arc[t] + 18.0 + rng.uniform(-4, 4)
        heading = poses[t, :3, 0]
        lateral = poses[t, :3, 1]
        for side in (-1.0, 1.0):
            # buildings with random gaps (vacant lots -> occlusion shadows)
            if rng.uniform() < 0.8:
                y_off = side * (9.0 + rng.uniform(0, 8))
                center = positions[t] + lateral * y_off + heading * rng.uniform(-6, 6)
                w, d, h = rng.uniform(6, 16), rng.uniform(4, 10), rng.uniform(4, 18)
                if clear_of_path(center, (w, d), 3.5):
                    rects.extend(
                        _box([center[0], center[1], -1.7 + h / 2], [w, d, h], 0.01)
                    )
            # street furniture: poles / trees at the curb
            if rng.uniform() < 0.5:
                p = positions[t] + lateral * side * rng.uniform(6.5, 8.0) \
                    + heading * rng.uniform(-8, 8)
                if clear_of_path(p, (0.3, 0.3), 2.5):
                    rects.extend(_box([p[0], p[1], 0.8], [0.3, 0.3, 5.0], 0.02))
        # parked cars at the curb
        if rng.uniform() < 0.5:
            side = rng.choice([-1.0, 1.0])
            p = positions[t] + lateral * side * rng.uniform(5.0, 6.5) \
                + heading * rng.uniform(0, 14)
            if clear_of_path(p, (4.2, 1.8), 2.5):
                rects.extend(_box([p[0], p[1], -0.95], [4.2, 1.8, 1.5], 0.02))
        # dynamic traffic: oncoming (opposite lane) or leading vehicles
        if rng.uniform() < 0.30:
            oncoming = rng.uniform() < 0.6
            lane = 3.0 if oncoming else 0.0
            speed = rng.uniform(0.4, 1.1)  # m/frame = 4-11 m/s at 10 Hz
            vel = heading * (-speed if oncoming else speed)
            start = (
                positions[t]
                + lateral * lane
                + heading * (rng.uniform(25, 60) if oncoming else rng.uniform(10, 25))
            )
            # back-date the spawn so the vehicle is at ``start`` when the ego
            # arrives (frame t), not at frame 0
            center0 = np.array([start[0], start[1], -0.95]) - vel * t
            # never drive through the ego: reject spawns whose straight-line
            # path comes within 2.5 m of the ego position at the same frame
            track = center0[None, :2] + vel[None, :2] * np.arange(len(poses))[:, None]
            if np.min(np.linalg.norm(track - positions[:, :2], axis=1)) < 2.5:
                continue
            dynamics.append(
                DynamicBox(
                    center=center0,
                    size=np.array([4.2, 1.8, 1.5]),
                    velocity=vel,
                )
            )
    return rects, dynamics


def lidar_directions(
    num_beams: int = 32, num_cols: int = 720,
    fov_up_deg: float = 3.0, fov_down_deg: float = -24.0,
) -> np.ndarray:
    """Unit ray directions of a rotating multi-beam LiDAR, scan order (beam-major)."""
    elevations = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, num_beams))
    azimuths = np.linspace(np.pi, -np.pi, num_cols, endpoint=False)
    el, az = np.meshgrid(elevations, azimuths, indexing="ij")
    return np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1
    ).reshape(-1, 3)


def make_trajectory(
    kind: str, n_frames: int, speed: float = 1.0, yaw_rate_deg: float = 0.5
) -> np.ndarray:
    """Analytic GT trajectories ``(T, 4, 4)`` (vehicle frame: x forward)."""
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    if kind == "straight":
        for t in range(n_frames):
            poses[t, 0, 3] = speed * t
    elif kind == "curve":
        # left curve at ``yaw_rate_deg`` per frame (default: gentle)
        yaw = 0.0
        pos = np.zeros(3)
        for t in range(n_frames):
            c, s = np.cos(yaw), np.sin(yaw)
            poses[t, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            poses[t, :3, 3] = pos
            pos = pos + np.array([c, s, 0.0]) * speed
            yaw += np.deg2rad(yaw_rate_deg)
    elif kind == "circle":
        radius = speed * n_frames / (2 * np.pi)
        for t in range(n_frames):
            ang = 2 * np.pi * t / n_frames
            c, s = np.cos(ang), np.sin(ang)
            poses[t, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            poses[t, :3, 3] = [radius * s, radius * (1 - c), 0.0]
    elif kind == "kitti_drive":
        # urban drive profile at 10 Hz mirroring real KITTI motion statistics
        # (ref docs/results/KITTI benchmark sequences): stop-start traffic,
        # sustained straights at ~12 m/s, 90-degree intersection turns at
        # slow speed, an S-curve, plus small suspension pitch/roll/bounce.
        # Phases: (frames, end_speed m/s, total_yaw_deg). Speed interpolates
        # linearly across the phase; yaw rate is uniform within it. ``speed``
        # scales the whole profile; n_frames truncates/extends (the final
        # phase repeats if n_frames exceeds the schedule).
        schedule = [
            (60, 12.0, 0.0),    # pull away, accelerate to 12 m/s
            (140, 12.0, 0.0),   # straight ~170 m
            (40, 4.0, -12.0),   # brake into a gentle right drift
            (50, 4.0, -78.0),   # 90-deg right turn at ~4 m/s
            (60, 10.0, 0.0),    # accelerate out
            (130, 10.0, 0.0),   # straight ~130 m
            (45, 0.0, 0.0),     # brake to a stop (traffic light)
            (25, 0.0, 0.0),     # standstill — zero-motion frames
            (55, 8.0, 20.0),    # pull away into a left drift
            (50, 8.0, 70.0),    # complete a 90-deg left turn
            (120, 13.0, 0.0),   # fast straight
            (60, 9.0, 35.0),    # S-curve half 1
            (60, 11.0, -35.0),  # S-curve half 2
            (100, 11.0, 0.0),   # run-out straight
        ]
        dt = 0.1
        yaw, v = 0.0, 0.0
        pos = np.zeros(3)
        t = 0
        phase_iter = iter(schedule + [schedule[-1]] * 1000)
        while t < n_frames:
            n_ph, v_end, yaw_tot = next(phase_iter)
            v_end = v_end * speed
            v0 = v
            for k in range(n_ph):
                if t >= n_frames:
                    break
                v = v0 + (v_end - v0) * (k + 1) / n_ph
                c, s = np.cos(yaw), np.sin(yaw)
                # suspension: ~0.3 deg pitch/roll sway + 2 cm vertical bounce
                pitch = 0.005 * np.sin(0.31 * t) * (v / 10.0 + 0.2)
                roll = 0.005 * np.sin(0.23 * t + 1.0) * (v / 10.0 + 0.2)
                cp, sp = np.cos(pitch), np.sin(pitch)
                cr, sr = np.cos(roll), np.sin(roll)
                r_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                r_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
                r_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
                poses[t, :3, :3] = r_yaw @ r_pitch @ r_roll
                poses[t, :3, 3] = pos + np.array(
                    [0.0, 0.0, 0.02 * np.sin(0.47 * t) * (v / 10.0)]
                )
                pos = pos + np.array([c, s, 0.0]) * v * dt
                yaw += np.deg2rad(yaw_tot / n_ph)
                t += 1
    elif kind == "there_and_back":
        # drive out along +x, then reverse back with a small lateral offset —
        # a rotation-free closed loop (exercises loop closure / backends
        # without stressing the odometry's per-frame rotation limits)
        half = n_frames // 2
        for t in range(n_frames):
            if t < half:
                poses[t, :3, 3] = [speed * t, 0.0, 0.0]
            else:
                poses[t, :3, 3] = [speed * (2 * half - t - 1), 0.5, 0.0]
    else:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    return poses


# bump when the world/raycaster OUTPUT changes for an unchanged config —
# cache keys combine this with a hash of the config so cached sequences can
# never go silently stale. The reference's value: the port makes its output.
GENERATOR_VERSION = 2


@dataclasses.dataclass(frozen=True)
class SyntheticSequenceConfig:
    n_frames: int = 50
    trajectory: str = "curve"
    speed: float = 1.0  # meters / frame
    yaw_rate_deg: float = 0.5  # deg / frame (for "curve")
    num_beams: int = 32
    num_cols: int = 720
    fov_up_deg: float = 3.0
    fov_down_deg: float = -24.0
    noise_std: float = 0.01  # range-noise sigma (meters), on top of surface roughness
    dropout: float = 0.1  # fraction of rays randomly dropped
    num_points: int = 8192  # output scan size (subsample/pad)
    seed: int = 0
    # simulate the rolling-shutter effect of a spinning LiDAR: each column is
    # measured from the pose interpolated between frame t (scan start) and
    # frame t+1, so a rigid interpretation of the scan is distorted. The GT
    # pose of frame t remains the scan-START pose.
    motion_distortion: bool = False
    # "corridor": straight street along +x (curving trajectories leave it
    # after ~70 frames and see only ground). "along_path": buildings placed
    # along the trajectory — use for long sequences. "kitti": hardened world
    # with rough ground, occlusion gaps, street furniture and moving traffic.
    world: str = "corridor"


def kitti_preset(
    n_frames: int = 995, seed: int = 3, **overrides
) -> SyntheticSequenceConfig:
    """64-beam HDL-64E-like sensor over the hardened ``kitti`` world on the
    ``kitti_drive`` motion profile — the accuracy-gate configuration of the
    reference's ``bench.py``. Sensor model per the reference KITTI projector:
    64 rings, vertical FOV +2 / −24.8 deg, ~2 cm range noise."""
    return SyntheticSequenceConfig(
        n_frames=n_frames,
        trajectory="kitti_drive",
        speed=1.0,
        num_beams=64,
        num_cols=720,
        fov_up_deg=2.0,
        fov_down_deg=-24.8,
        noise_std=0.02,
        dropout=0.08,
        world="kitti",
        seed=seed,
        **overrides,
    )


def _interp_pose(pose0: np.ndarray, pose1: np.ndarray, alpha: float) -> np.ndarray:
    """Slerp rotation + lerp translation between two 4x4 poses (host side)."""
    from scipy.spatial.transform import Rotation, Slerp

    slerp = Slerp([0.0, 1.0], Rotation.from_matrix([pose0[:3, :3], pose1[:3, :3]]))
    out = np.eye(4)
    out[:3, :3] = slerp([alpha])[0].as_matrix()
    out[:3, 3] = (1.0 - alpha) * pose0[:3, 3] + alpha * pose1[:3, 3]
    return out


def generate_sequence_with_times(
    config: SyntheticSequenceConfig = SyntheticSequenceConfig(),
    world: Optional[List[Rect]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Simulate a sequence; also return per-point intra-scan timestamps.

    Returns ``(scans (T, num_points, 3), times (T, num_points), poses (T, 4, 4))``.
    Scans are in the sensor frame (of the instant each point was measured, if
    ``motion_distortion``; of the frame pose otherwise), zero-padded; ``times``
    are the fraction of the scan period in [0, 1) at which each point was
    taken (0 for padding); poses are ground-truth scan-start sensor poses.
    Rigid sweeps are cast by :class:`FrameRaycaster` on ``device``; sweeps
    distorted by motion by the numpy :func:`raycast_hits`, as in the
    reference.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    dirs_sensor = lidar_directions(
        config.num_beams, config.num_cols, config.fov_up_deg, config.fov_down_deg
    )
    poses = make_trajectory(
        config.trajectory, config.n_frames, config.speed, config.yaw_rate_deg
    )
    dynamics: List[DynamicBox] = []
    if world is not None:
        rects = world
    elif config.world == "kitti":
        rects, dynamics = kitti_world(poses, config.seed)
    elif config.world == "along_path":
        rects = world_along_path(poses, config.seed)
    else:
        rects = default_world(config.seed)
    static_soa = RectSoA(rects)

    def frame_soa(t: int) -> RectSoA:
        if not dynamics:
            return static_soa
        return RectSoA(rects + [r for d in dynamics for r in d.rects_at(t)])

    def cast(soa: RectSoA, origin, d_world):
        """Ranges with per-surface roughness folded into the range noise."""
        ranges, idx = raycast_hits(soa, origin, d_world)
        sigma = config.noise_std + np.where(idx >= 0, soa.roughness[idx], 0.0)
        return ranges + rng.normal(size=ranges.shape) * sigma

    # column index of each ray in beam-major scan order -> intra-scan time
    col_of_ray = np.tile(np.arange(config.num_cols), config.num_beams)
    alpha_of_ray = col_of_ray.astype(np.float64) / config.num_cols

    # discretize the sweep into pose sub-steps (full slerp per ray is slow)
    n_sub = 24

    scans = np.zeros((config.n_frames, config.num_points, 3), np.float32)
    times = np.zeros((config.n_frames, config.num_points), np.float32)

    if not config.motion_distortion:
        # rigid sweeps: the caster casts every frame on the device; the host
        # loop only adds noise/dropout and samples points
        ranges_all, idx_all, rough = cast_rigid_sweeps(
            rects, dynamics, poses, dirs_sensor, device)
        for t in range(config.n_frames):
            ranges, idx = ranges_all[t], idx_all[t]
            sigma = config.noise_std + np.where(idx >= 0, rough[idx], 0.0)
            ranges = ranges + rng.normal(size=ranges.shape) * sigma
            ok = np.isfinite(ranges)
            if config.dropout > 0:
                ok &= rng.uniform(size=ok.shape) > config.dropout
            pts = dirs_sensor[ok] * ranges[ok, None]
            tstamps = alpha_of_ray[ok]
            n = min(len(pts), config.num_points)
            sel = (
                rng.choice(len(pts), n, replace=False)
                if len(pts) > n
                else np.arange(len(pts))
            )
            scans[t, : len(sel)] = pts[sel]
            times[t, : len(sel)] = tstamps[sel]
        return scans, times, poses.astype(np.float64)

    for t in range(config.n_frames):
        soa_t = frame_soa(t)
        if t + 1 < config.n_frames:
            pose_next = poses[t + 1]
        else:
            # constant-velocity extrapolation: the last scan must be
            # distorted like all others, not silently rigid
            pose_next = poses[t] @ (np.linalg.inv(poses[t - 1]) @ poses[t])
        sub_idx = np.minimum((alpha_of_ray * n_sub).astype(int), n_sub - 1)
        pts_list, time_list = [], []
        for s in range(n_sub):
            sel_rays = sub_idx == s
            if not np.any(sel_rays):
                continue
            pose_s = _interp_pose(poses[t], pose_next, (s + 0.5) / n_sub)
            rot, origin = pose_s[:3, :3], pose_s[:3, 3]
            d_sensor = dirs_sensor[sel_rays]
            d_world = d_sensor @ rot.T
            ranges = cast(soa_t, origin, d_world)
            ok = np.isfinite(ranges)
            if config.dropout > 0:
                ok &= rng.uniform(size=ok.shape) > config.dropout
            pts_list.append(d_sensor[ok] * ranges[ok, None])
            time_list.append(alpha_of_ray[sel_rays][ok])
        pts = np.concatenate(pts_list)
        tstamps = np.concatenate(time_list)
        n = min(len(pts), config.num_points)
        sel = rng.choice(len(pts), n, replace=False) if len(pts) > n else np.arange(len(pts))
        scans[t, : len(sel)] = pts[sel]
        times[t, : len(sel)] = tstamps[sel]
    return scans, times, poses.astype(np.float64)


def cast_rigid_sweeps(
    rects: List[Rect], dynamics: List[DynamicBox], poses: np.ndarray,
    dirs_sensor: np.ndarray, device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every rigid frame's ``(ranges (T, N), rect index (T, N))`` from one
    :class:`FrameRaycaster` over the static rects followed by each frame's
    instances of the moving boxes (5 rects a box a frame, frame after
    frame), with the caster's per-rect roughness."""
    t_frames = len(poses)
    dyn_rects = [r for t in range(t_frames) for d in dynamics for r in d.rects_at(t)]
    per_frame = len(dyn_rects) // t_frames if dynamics else 0
    caster = FrameRaycaster(rects + dyn_rects, n_static=len(rects), device=device)
    extra_sets = None
    if dynamics:
        base = len(rects)
        extra_sets = [
            np.arange(base + t * per_frame, base + (t + 1) * per_frame)
            for t in range(t_frames)
        ]
    ranges_all, idx_all = caster.cast_all(poses, dirs_sensor, extra_sets)
    return ranges_all, idx_all, caster.soa.roughness


@span("data.filter")
def filter_scan_sensor_frame(
    pc: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
    ground_z: float = -1.4,
    near: float = 30.0,
) -> np.ndarray:
    """Ground/range filter + resample to exactly ``num_points``: the
    deep-odometry input filter in the synthetic sensor frame (z up, ground
    plane at −1.7 m). Padding rows (zeros) never survive."""
    count("data.points_in", len(pc))
    valid = np.linalg.norm(pc, axis=-1) > 1e-3
    is_ground = pc[:, 2] < ground_z
    keep = valid & ~is_ground & (np.abs(pc[:, 0]) < near) & (np.abs(pc[:, 1]) < near)
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        idx = np.nonzero(valid)[0]
    if len(idx) >= num_points:
        sel = rng.choice(idx, num_points, replace=False)
    else:
        sel = np.concatenate(
            [idx, rng.choice(idx, num_points - len(idx), replace=True)]
        )
    return pc[sel].astype(np.float32)


@dataclasses.dataclass
class SyntheticPairDataset:
    """PWCLO-Net training pairs over synthetic-world sequences.

    Same batch contract as ``data.kitti.KittiPairDataset`` (``{"xyz1":
    current, "xyz2": previous, "gt_params": (t, q_wxyz) mapping xyz1 coords →
    xyz2 coords}``) with the same filter and random-SE(3) augmentation,
    sourced from raycast worlds instead of disk. The numpy random streams
    are the reference's, so one seed gives both the same batches.

    ``sequences``: list of ``(scans (T, N, 3), gt_poses (T, 4, 4))``.
    """

    sequences: List[Tuple[np.ndarray, np.ndarray]]
    num_points: int = 8192
    max_frame_gap: int = 1
    augment: bool = True
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._index = [
            (s, i)
            for s, (scans, _) in enumerate(self.sequences)
            for i in range(1, len(scans))
        ]

    def __len__(self):
        return len(self._index)

    @span("data.pair")
    def __getitem__(self, index: int) -> dict:
        s, i2 = self._index[index]
        scans, poses = self.sequences[s]
        gap = int(self._rng.integers(1, self.max_frame_gap + 1))
        i1 = max(i2 - gap, 0)
        p_prev = filter_scan_sensor_frame(scans[i1], self.num_points, self._rng)
        p_cur = filter_scan_sensor_frame(scans[i2], self.num_points, self._rng)

        # rel maps current-frame coords into previous-frame coords
        t_rel = np.linalg.inv(poses[i1]) @ poses[i2]
        if self.augment:
            with span("data.augment"):
                t_aug = random_augmentation(self._rng)
                hom = np.concatenate([p_cur, np.ones((self.num_points, 1))], -1)
                p_cur = (t_aug @ hom.T).T[:, :3].astype(np.float32)
                t_gt = t_rel @ np.linalg.inv(t_aug)
        else:
            t_gt = t_rel
        return {"xyz1": p_cur, "xyz2": p_prev, "gt_params": pose_to_params(t_gt)}

    def batches(self, batch_size: int, shuffle: bool = True, seed: Optional[int] = None):
        order = np.arange(len(self))
        if shuffle:
            (np.random.default_rng(seed) if seed is not None else self._rng).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(i)] for i in order[start : start + batch_size]]
            with span("data.collate"):
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            yield batch


def generate_sequence(
    config: SyntheticSequenceConfig = SyntheticSequenceConfig(),
    world: Optional[List[Rect]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate a sequence. Returns ``(scans (T, num_points, 3), poses (T, 4, 4))``.

    Scans are in the sensor frame, zero-padded to ``num_points``; poses are
    ground-truth absolute sensor poses. Rigid sweeps are cast on ``device``.
    """
    scans, _times, poses = generate_sequence_with_times(config, world, device)
    return scans, poses
