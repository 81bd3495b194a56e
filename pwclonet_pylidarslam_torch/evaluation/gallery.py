"""Offline per-run HTML gallery — the headless replacement for the
reference's live visualization (``slam/viz/visualizer.py:22`` cv2 windows and
the viz3d OpenGL viewer, which need a display).

One self-contained directory per sequence:

- ``index.html`` — everything on one scrollable page;
- trajectory overlay (2D path, 3D path, xyz, rpy) PNGs;
- a strip of sampled frames, each with its spherical vertex-map depth image
  and BEV occupancy image (``evaluation/viz.py`` renderers).

The port's counterpart of ``pwclonet_pylidarslam_tpu/evaluation/gallery.py``:
the vertex maps come from the port's projector, on the device the caller
names (the run's device); the images and plots need matplotlib, as the
reference's do. Wired into ``run_slam_torch.py`` via ``gallery=true``.
"""

from __future__ import annotations

import html
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from pwclonet_pylidarslam_torch.core.projection import density_matched_projector
from pwclonet_pylidarslam_torch.device import resolve_device
from pwclonet_pylidarslam_torch.evaluation import viz
from pwclonet_pylidarslam_torch.evaluation.results import (
    plot_path_2d_3,
    plot_path_3d,
    plot_rpy,
    plot_xyz,
)


def write_run_gallery(
    out_dir: str,
    name: str,
    scans: Sequence[np.ndarray],
    predicted: np.ndarray,
    ground_truth: Optional[np.ndarray] = None,
    projector=None,
    max_frames: int = 12,
    metrics: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> str:
    """Render the gallery; returns the ``index.html`` path.

    ``scans``: random-access per-frame point clouds (only ``max_frames``
    evenly spaced frames are rendered). ``projector`` defaults to the
    density-matched spherical projector; the vertex maps are built on
    ``device``, CUDA unless the caller asks for the CPU.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t = len(predicted)
    idxs = np.unique(np.linspace(0, t - 1, min(max_frames, t)).astype(int))

    if projector is None:
        first = np.asarray(scans[int(idxs[0])])
        projector = density_matched_projector(first.shape[0])

    plot_path_2d_3(os.path.join(out_dir, "path_2d.png"), predicted,
                   ground_truth, title=name)
    plot_path_3d(os.path.join(out_dir, "path_3d.png"), predicted,
                 ground_truth, title=name)
    plot_xyz(os.path.join(out_dir, "xyz.png"), predicted, ground_truth, title=name)
    plot_rpy(os.path.join(out_dir, "rpy.png"), predicted, ground_truth, title=name)

    frame_rows = []
    for i in idxs:
        pts = np.asarray(scans[int(i)], np.float32)[:, :3]
        vm = vertex_map(projector, pts, device)
        vm_img = viz.vertex_map_image(vm, channel="depth")
        bev = viz.bev_image(pts)
        viz.save_image(os.path.join(out_dir, f"frame_{i:06d}_vm.png"), vm_img)
        viz.save_image(os.path.join(out_dir, f"frame_{i:06d}_bev.png"), bev)
        frame_rows.append(
            f'<div class="frame"><h3>frame {i}</h3>'
            f'<img src="frame_{i:06d}_vm.png" alt="vertex map {i}">'
            f'<img class="bev" src="frame_{i:06d}_bev.png" alt="BEV {i}"></div>'
        )

    metric_html = ""
    if metrics:
        cells = "".join(
            f"<tr><td>{html.escape(str(k))}</td><td>{v:.4f}</td></tr>"
            for k, v in metrics.items()
            if isinstance(v, (int, float)) and np.isfinite(v)
        )
        metric_html = f"<table><tr><th>metric</th><th>value</th></tr>{cells}</table>"

    page = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(name)} — run gallery</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; background: #fafafa; }}
 img {{ max-width: 100%; image-rendering: pixelated; border: 1px solid #ccc; }}
 .row img {{ max-width: 48%; }}
 .frame {{ margin-bottom: 1.5em; }}
 .frame img {{ display: block; margin-bottom: 4px; }}
 .frame img.bev {{ max-width: 320px; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #999; padding: 2px 8px; }}
</style></head><body>
<h1>{html.escape(name)}</h1>
<p><a href="player.html" style="color:#06c">&#9654; interactive player</a>
(frame-by-frame playback, world-frame map overlay, drag-rotate 3D view)</p>
{metric_html}
<h2>Trajectory</h2>
<div class="row"><img src="path_2d.png"><img src="path_3d.png"></div>
<div class="row"><img src="xyz.png"><img src="rpy.png"></div>
<h2>Sampled frames (vertex map depth + BEV)</h2>
{''.join(frame_rows)}
</body></html>
"""
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(page)
    return index


def vertex_map(projector, points: np.ndarray, device: Union[str, torch.device]) -> np.ndarray:
    """The ``(H, W, 3)`` vertex map of one ``(N, 3)`` scan, built on
    ``device`` and brought back to the host."""
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    return projector.build_projection_map(pts[None])[0].cpu().numpy()
