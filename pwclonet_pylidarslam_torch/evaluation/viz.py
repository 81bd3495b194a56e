"""Visualization helpers (ref ``slam/viz/``: color maps, tensor→image).

The port's own copy of ``pwclonet_pylidarslam_tpu/evaluation/viz.py``
(numpy; matplotlib is imported inside the functions that need it).

Headless replacements for the reference's cv2/OpenGL windows (dropped on
purpose — compute nodes are headless): everything renders to arrays / PNG files.
"""

from __future__ import annotations

import numpy as np


def colorize(values: np.ndarray, cmap: str = "viridis", vmin=None, vmax=None) -> np.ndarray:
    """Scalar array → uint8 RGB via matplotlib colormaps
    (ref ``viz/color_map.py:19-155``)."""
    import matplotlib

    vmin = np.nanmin(values) if vmin is None else vmin
    vmax = np.nanmax(values) if vmax is None else vmax
    norm = (values - vmin) / max(vmax - vmin, 1e-12)
    rgba = matplotlib.colormaps[cmap](np.clip(norm, 0, 1))
    return (rgba[..., :3] * 255).astype(np.uint8)


def vertex_map_image(vertex_map: np.ndarray, channel: str = "depth") -> np.ndarray:
    """Vertex map ``(H, W, 3+)`` → uint8 RGB image (depth / height coloring)."""
    vm = np.asarray(vertex_map)
    depth = np.linalg.norm(vm[..., :3], axis=-1)
    mask = depth > 0
    if channel == "depth":
        vals = depth
    elif channel == "height":
        vals = vm[..., 2]
    else:
        raise ValueError(f"unknown channel {channel!r}")
    vals = np.where(mask, vals, np.nan)
    img = colorize(vals, vmin=np.nanpercentile(vals, 2), vmax=np.nanpercentile(vals, 98))
    img[~mask] = 0
    return img


def save_image(path: str, image: np.ndarray):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, image)


def bev_image(points: np.ndarray, pixel_size: float = 0.4, size: int = 512) -> np.ndarray:
    """Quick top-down occupancy/elevation render of a cloud (debugging aid)."""
    img = np.full((size, size), -np.inf, np.float32)
    px = np.round(points[:, 0] / pixel_size + size // 2).astype(int)
    py = np.round(points[:, 1] / pixel_size + size // 2).astype(int)
    ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
    ok &= np.linalg.norm(points, axis=-1) > 1e-6
    np.maximum.at(img, (px[ok], py[ok]), points[ok, 2])
    occupied = np.isfinite(img)
    floor = img[occupied].min() if occupied.any() else 0.0
    out = colorize(np.where(occupied, img, floor))
    out[~occupied] = 0
    return out
