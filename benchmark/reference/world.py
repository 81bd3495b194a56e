"""The KITTI-profile synthetic world: a frozen copy of the generator the
benchmark casts its drives with.

A copy of ``kitti_preset``'s world (rough ground, buildings with gaps,
poles, parked cars, moving traffic), the ``kitti_drive`` trajectory, the
HDL-64E-like beam pattern and the rigid-sweep caster with its host loop
(range noise by surface, ray dropout), as the port's ``data/synthetic.py``
had them when this benchmark was written. A scan keeps every return, as a
recorded sweep does; the program samples its input from it.
The benchmark keeps its own copy so that a change to the program's generator
cannot change what the benchmark feeds it. Plain numpy and torch; the cast
runs on the device it is given, in a few large batches of frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Rect:
    origin: np.ndarray
    u: np.ndarray
    v: np.ndarray
    roughness: float = 0.0

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.u, self.v)
        return n / np.linalg.norm(n)


def _box(center, size, roughness: float = 0.0) -> List[Rect]:
    """An axis-aligned box as its four sides and its top."""
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
    center: np.ndarray
    size: np.ndarray
    velocity: np.ndarray
    roughness: float = 0.02

    def rects_at(self, t: int) -> List[Rect]:
        return _box(np.asarray(self.center) + np.asarray(self.velocity) * t, self.size,
                    self.roughness)


def kitti_world(poses: np.ndarray, seed: int) -> Tuple[List[Rect], List[DynamicBox]]:
    """Static rects and moving boxes along the trajectory ``poses (T, 4, 4)``."""
    rng = np.random.default_rng(seed)
    positions = poses[:, :3, 3]
    lo = positions.min(axis=0) - 150.0
    hi = positions.max(axis=0) + 150.0
    rects = [Rect(np.array([lo[0], lo[1], -1.7]), np.array([hi[0] - lo[0], 0, 0]),
                  np.array([0, hi[1] - lo[1], 0]), roughness=0.03)]

    def clear_of_path(center, size, margin) -> bool:
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
            if rng.uniform() < 0.8:  # buildings with gaps
                y_off = side * (9.0 + rng.uniform(0, 8))
                center = positions[t] + lateral * y_off + heading * rng.uniform(-6, 6)
                w, d, h = rng.uniform(6, 16), rng.uniform(4, 10), rng.uniform(4, 18)
                if clear_of_path(center, (w, d), 3.5):
                    rects.extend(_box([center[0], center[1], -1.7 + h / 2], [w, d, h], 0.01))
            if rng.uniform() < 0.5:  # poles at the curb
                p = positions[t] + lateral * side * rng.uniform(6.5, 8.0) \
                    + heading * rng.uniform(-8, 8)
                if clear_of_path(p, (0.3, 0.3), 2.5):
                    rects.extend(_box([p[0], p[1], 0.8], [0.3, 0.3, 5.0], 0.02))
        if rng.uniform() < 0.5:  # parked cars
            side = rng.choice([-1.0, 1.0])
            p = positions[t] + lateral * side * rng.uniform(5.0, 6.5) \
                + heading * rng.uniform(0, 14)
            if clear_of_path(p, (4.2, 1.8), 2.5):
                rects.extend(_box([p[0], p[1], -0.95], [4.2, 1.8, 1.5], 0.02))
        if rng.uniform() < 0.30:  # traffic, oncoming or leading
            oncoming = rng.uniform() < 0.6
            lane = 3.0 if oncoming else 0.0
            speed = rng.uniform(0.4, 1.1)
            vel = heading * (-speed if oncoming else speed)
            start = (positions[t] + lateral * lane
                     + heading * (rng.uniform(25, 60) if oncoming else rng.uniform(10, 25)))
            center0 = np.array([start[0], start[1], -0.95]) - vel * t
            track = center0[None, :2] + vel[None, :2] * np.arange(len(poses))[:, None]
            if np.min(np.linalg.norm(track - positions[:, :2], axis=1)) < 2.5:
                continue
            dynamics.append(DynamicBox(center=center0, size=np.array([4.2, 1.8, 1.5]),
                                       velocity=vel))
    return rects, dynamics


def lidar_directions(num_beams: int, num_cols: int, fov_up_deg: float,
                     fov_down_deg: float) -> np.ndarray:
    """Unit ray directions of a spinning multi-beam sensor, beam-major."""
    elevations = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, num_beams))
    azimuths = np.linspace(np.pi, -np.pi, num_cols, endpoint=False)
    el, az = np.meshgrid(elevations, azimuths, indexing="ij")
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
                    -1).reshape(-1, 3)


# (frames, end speed m/s, total yaw deg) of the urban drive profile at 10 Hz
_DRIVE = [(60, 12.0, 0.0), (140, 12.0, 0.0), (40, 4.0, -12.0), (50, 4.0, -78.0),
          (60, 10.0, 0.0), (130, 10.0, 0.0), (45, 0.0, 0.0), (25, 0.0, 0.0),
          (55, 8.0, 20.0), (50, 8.0, 70.0), (120, 13.0, 0.0), (60, 9.0, 35.0),
          (60, 11.0, -35.0), (100, 11.0, 0.0)]


def kitti_drive(n_frames: int, start: int = 0) -> np.ndarray:
    """``(n_frames, 4, 4)`` poses of the KITTI-like drive profile, frames
    ``start`` to ``start + n_frames`` of it, re-anchored at the identity."""
    total = start + n_frames
    poses = np.tile(np.eye(4), (total, 1, 1))
    yaw, v, t = 0.0, 0.0, 0
    pos = np.zeros(3)
    phases = iter(_DRIVE + [_DRIVE[-1]] * 1000)
    while t < total:
        n_ph, v_end, yaw_tot = next(phases)
        v0 = v
        for k in range(n_ph):
            if t >= total:
                break
            v = v0 + (v_end - v0) * (k + 1) / n_ph
            c, s = np.cos(yaw), np.sin(yaw)
            pitch = 0.005 * np.sin(0.31 * t) * (v / 10.0 + 0.2)
            roll = 0.005 * np.sin(0.23 * t + 1.0) * (v / 10.0 + 0.2)
            cp, sp, cr, sr = np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
            r_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            r_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            r_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
            poses[t, :3, :3] = r_yaw @ r_pitch @ r_roll
            poses[t, :3, 3] = pos + np.array([0.0, 0.0, 0.02 * np.sin(0.47 * t) * (v / 10.0)])
            pos = pos + np.array([c, s, 0.0]) * v * 0.1
            yaw += np.deg2rad(yaw_tot / n_ph)
            t += 1
    poses = poses[start:]
    return np.linalg.inv(poses[0]) @ poses


def _fma(a, b, c):
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _dot3(x, y):
    return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


def _cast_batch(arrays, sel, valid, poses, dirs, t_min, t_max):
    g_origin, g_u, g_v, g_normal, g_uu, g_vv = arrays
    origin = poses[:, None, :3, 3]
    rot = poses[:, :3, :3]
    o_r, u, v, nr = (g[sel][:, None] for g in (g_origin, g_u, g_v, g_normal))
    uu, vv = g_uu[sel][:, None], g_vv[sel][:, None]
    d_world = _dot3(dirs[None, :, None, :], rot[:, None, :, :])[:, :, None, :]
    rel0 = o_r - origin[:, :, None, :]
    denom = _dot3(d_world, nr)
    t = _dot3(rel0, nr) / denom
    a = _fma(t, _dot3(d_world, u), -_dot3(rel0, u)) / uu
    b = _fma(t, _dot3(d_world, v), -_dot3(rel0, v)) / vv
    ok = ((torch.abs(denom) > 1e-9) & (t > t_min) & (t < t_max)
          & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & valid[:, None, :])
    t = torch.where(ok, t, torch.inf)
    j = torch.argmin(t, dim=2)
    tb = torch.gather(t, 2, j[..., None])[..., 0]
    idx = torch.where(torch.isfinite(tb), torch.gather(sel, 1, j), -1)
    return tb, idx


def cast_drive(poses: np.ndarray, rects: List[Rect], dynamics: List[DynamicBox],
               dirs: np.ndarray, device: torch.device, t_min: float = 1.5,
               t_max: float = 80.0, tile: int = 1 << 24):
    """Ranges ``(T, rays)`` and hit rect ``(T, rays)`` of every rigid sweep,
    with the roughness of each rect: host culling, the cast on ``device``."""
    n_frames = len(poses)
    dyn = [r for t in range(n_frames) for d in dynamics for r in d.rects_at(t)]
    per_frame = len(dyn) // n_frames if dynamics else 0
    every = rects + dyn
    origin = np.stack([r.origin for r in every]).astype(np.float32)
    u = np.stack([r.u for r in every]).astype(np.float32)
    v = np.stack([r.v for r in every]).astype(np.float32)
    normal = np.stack([r.normal for r in every]).astype(np.float32)
    rough = np.array([r.roughness for r in every], np.float32)
    center = (origin + 0.5 * u + 0.5 * v)[: len(rects)]
    radius = (0.5 * np.linalg.norm(u + v, axis=-1))[: len(rects)]
    sels = []
    for t in range(n_frames):
        near = np.linalg.norm(center - poses[t, :3, 3], axis=-1) <= t_max + radius
        idx = np.nonzero(near)[0]
        if per_frame:
            base = len(rects) + t * per_frame
            idx = np.concatenate([idx, np.arange(base, base + per_frame)])
        sels.append(idx)
    r_max = ((max(1, max(len(s) for s in sels)) + 31) // 32) * 32
    sel = np.zeros((n_frames, r_max), np.int64)
    valid = np.zeros((n_frames, r_max), bool)
    for t, s in enumerate(sels):
        sel[t, : len(s)] = s
        valid[t, : len(s)] = True
    arrays = tuple(torch.from_numpy(a).to(device) for a in (
        origin, u, v, normal, np.einsum("rd,rd->r", u, u), np.einsum("rd,rd->r", v, v)))
    sel_d, valid_d = torch.from_numpy(sel).to(device), torch.from_numpy(valid).to(device)
    poses_d = torch.from_numpy(poses.astype(np.float32)).to(device)
    dirs_d = torch.from_numpy(dirs.astype(np.float32)).to(device)
    n_rays = dirs_d.shape[0]
    frames = max(1, tile // (n_rays * r_max))
    rays = min(n_rays, max(1, tile // r_max))
    ranges = torch.empty((n_frames, n_rays), dtype=torch.float32, device=device)
    hit = torch.empty((n_frames, n_rays), dtype=torch.int64, device=device)
    for f in range(0, n_frames, frames):
        for n in range(0, n_rays, rays):
            ranges[f: f + frames, n: n + rays], hit[f: f + frames, n: n + rays] = _cast_batch(
                arrays, sel_d[f: f + frames], valid_d[f: f + frames], poses_d[f: f + frames],
                dirs_d[n: n + rays], t_min, t_max)
    return ranges.cpu().numpy(), hit.cpu().numpy(), rough


@dataclasses.dataclass(frozen=True)
class Sensor:
    """The sensor and scan model of a configuration's ``input`` block."""

    num_beams: int
    num_cols: int
    fov_up_deg: float
    fov_down_deg: float
    noise_std: float
    dropout: float


def make_drive(sensor: Sensor, n_frames: int, seed: int, device: torch.device,
               start: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """One drive of ``n_frames`` frames from frame ``start`` of the profile:
    ``(scans, poses (T, 4, 4) float64)``, each scan every return of its sweep
    ``(hits, 3) float32`` in the sensor frame. The world and the noise come
    from ``seed``."""
    rng = np.random.default_rng(seed)
    dirs = lidar_directions(sensor.num_beams, sensor.num_cols, sensor.fov_up_deg,
                            sensor.fov_down_deg)
    poses = kitti_drive(n_frames, start)
    rects, dynamics = kitti_world(poses, seed)
    ranges_all, idx_all, rough = cast_drive(poses, rects, dynamics, dirs, device)
    scans = []
    for t in range(n_frames):
        ranges, idx = ranges_all[t], idx_all[t]
        sigma = sensor.noise_std + np.where(idx >= 0, rough[idx], 0.0)
        ranges = ranges + rng.normal(size=ranges.shape) * sigma
        ok = np.isfinite(ranges)
        if sensor.dropout > 0:
            ok &= rng.uniform(size=ok.shape) > sensor.dropout
        scans.append((dirs[ok] * ranges[ok, None]).astype(np.float32))
    return scans, poses
