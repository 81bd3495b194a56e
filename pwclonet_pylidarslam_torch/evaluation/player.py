"""Offline interactive run player — frame-by-frame playback without a display.

The port's own copy of ``pwclonet_pylidarslam_tpu/evaluation/player.py``
(numpy): for the same inputs it writes the same bytes.

Closes the reference's *live* visualization gap (cv2 windows
``slam/viz/visualizer.py:22`` + the viz3d OpenGL 3D viewer) headlessly: one
self-contained ``player.html`` (no network, no external JS) with

- a play/pause/scrub timeline over every frame of the run;
- a top-down map canvas: full predicted (and GT) trajectory, the current
  pose marker, and the current scan rendered in WORLD frame through the
  predicted pose — drift is visible as the scan detaching from the map;
- a drag-to-rotate / wheel-to-zoom 3D view of the same scan (perspective
  projection implemented in-page);
- an accumulate toggle that overlays the last ``ACC`` scans as a local map.

Per-frame clouds are downsampled and quantized to int16 centimeters, then
base64-embedded, so a 1000-frame run stays a few MB.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence

import numpy as np


def _pack_i16(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr, dtype="<i2").tobytes()).decode()


def write_run_player(
    out_dir: str,
    name: str,
    scans: Sequence[np.ndarray],
    predicted: np.ndarray,
    ground_truth: Optional[np.ndarray] = None,
    points_per_frame: int = 768,
    scale: float = 0.01,
) -> str:
    """Write ``player.html``; returns its path.

    ``scans``: random-access per-frame clouds (sensor frame); ``predicted``
    ``(T, 4, 4)`` absolute poses. Clouds are random-downsampled to
    ``points_per_frame`` and quantized at ``scale`` meters (int16 → ±327 m).
    """
    os.makedirs(out_dir, exist_ok=True)
    t = len(predicted)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(t):
        pts = np.asarray(scans[i], np.float32)[:, :3]
        valid = np.linalg.norm(pts, axis=-1) > 1e-3
        pts = pts[valid]
        if len(pts) > points_per_frame:
            pts = pts[rng.choice(len(pts), points_per_frame, replace=False)]
        q = np.clip(np.round(pts / scale), -32767, 32767).astype(np.int16)
        frames.append(_pack_i16(q))

    data = {
        "name": name,
        "scale": scale,
        "poses": np.asarray(predicted, np.float32).round(4).reshape(t, 16).tolist(),
        "gt": (
            np.asarray(ground_truth, np.float32).round(4).reshape(-1, 16).tolist()
            if ground_truth is not None
            else None
        ),
        "frames": frames,
    }

    page = _TEMPLATE.replace("__DATA__", json.dumps(data))
    path = os.path.join(out_dir, "player.html")
    with open(path, "w") as f:
        f.write(page)
    return path


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>run player</title>
<style>
 body { font-family: sans-serif; margin: 1em; background: #111; color: #ddd; }
 canvas { background: #000; border: 1px solid #444; }
 .views { display: flex; gap: 12px; flex-wrap: wrap; }
 .bar { margin: 8px 0; display: flex; gap: 8px; align-items: center; }
 input[type=range] { width: 420px; }
 button { background: #333; color: #ddd; border: 1px solid #555; padding: 4px 10px; }
 label { user-select: none; }
</style></head><body>
<h2 id="title"></h2>
<div class="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="seek" min="0" value="0">
 <span id="frameno"></span>
 <label><input type="checkbox" id="acc" checked> accumulate</label>
 <label>speed <select id="speed"><option value="1">1</option><option value="2" selected>2</option><option value="4">4</option><option value="8">8</option></select></label>
</div>
<div class="views">
 <div><div>top-down (world frame)</div><canvas id="map" width="640" height="640"></canvas></div>
 <div><div>3D scan (drag = rotate, wheel = zoom)</div><canvas id="c3d" width="640" height="640"></canvas></div>
</div>
<script>
const D = __DATA__;
const T = D.frames.length, ACC = 25;
const clouds = D.frames.map(b64 => {
  const raw = atob(b64), n = raw.length / 2;
  const buf = new Int16Array(n);
  for (let i = 0; i < n; i++) buf[i] = (raw.charCodeAt(2*i) | (raw.charCodeAt(2*i+1) << 8)) << 16 >> 16;
  return buf;
});
document.getElementById('title').textContent = D.name + ' — ' + T + ' frames';
const seek = document.getElementById('seek'); seek.max = T - 1;
const mapC = document.getElementById('map').getContext('2d');
const c3dC = document.getElementById('c3d').getContext('2d');
let cur = 0, playing = false, yaw = -0.8, pitch = 0.5, dist = 60;

function pose(i) { return D.poses[i]; }
function worldPts(i) {
  const p = pose(i), c = clouds[i], s = D.scale, out = new Float32Array(c.length);
  for (let j = 0; j < c.length; j += 3) {
    const x = c[j]*s, y = c[j+1]*s, z = c[j+2]*s;
    out[j]   = p[0]*x + p[1]*y + p[2]*z  + p[3];
    out[j+1] = p[4]*x + p[5]*y + p[6]*z  + p[7];
    out[j+2] = p[8]*x + p[9]*y + p[10]*z + p[11];
  }
  return out;
}
// world-frame bounding box of the trajectory for the map view
let bx0=1e9,bx1=-1e9,by0=1e9,by1=-1e9;
for (const p of D.poses) { bx0=Math.min(bx0,p[3]); bx1=Math.max(bx1,p[3]); by0=Math.min(by0,p[7]); by1=Math.max(by1,p[7]); }
const pad = 0.12*Math.max(bx1-bx0, by1-by0) + 18;
bx0-=pad; bx1+=pad; by0-=pad; by1+=pad;
const mw = 640 / Math.max(bx1-bx0, by1-by0);
function mx(x) { return (x - bx0) * mw; }
function my(y) { return 640 - (y - by0) * mw; }

function drawMap(i) {
  mapC.clearRect(0,0,640,640);
  if (D.gt) { mapC.strokeStyle = '#2a6'; mapC.beginPath();
    D.gt.forEach((p,k)=>{ k?mapC.lineTo(mx(p[3]),my(p[7])):mapC.moveTo(mx(p[3]),my(p[7])); }); mapC.stroke(); }
  mapC.strokeStyle = '#e74'; mapC.beginPath();
  for (let k=0;k<=i;k++){const p=pose(k); k?mapC.lineTo(mx(p[3]),my(p[7])):mapC.moveTo(mx(p[3]),my(p[7]));}
  mapC.stroke();
  const from = document.getElementById('acc').checked ? Math.max(0, i-ACC+1) : i;
  for (let f=from; f<=i; f++) {
    const w = worldPts(f), age = (i-f)/ACC;
    mapC.fillStyle = 'rgba(120,170,255,' + (0.55*(1-age)+0.08).toFixed(2) + ')';
    for (let j=0;j<w.length;j+=3) mapC.fillRect(mx(w[j]), my(w[j+1]), 1.3, 1.3);
  }
  const p = pose(i);
  mapC.fillStyle = '#fff'; mapC.beginPath();
  mapC.arc(mx(p[3]), my(p[7]), 4, 0, 6.3); mapC.fill();
}

function draw3d(i) {
  c3dC.clearRect(0,0,640,640);
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const c = clouds[i], s = D.scale;
  for (let j=0;j<c.length;j+=3) {
    const x=c[j]*s, y=c[j+1]*s, z=c[j+2]*s;
    const rx =  cy*x + sy*y;
    const ry = -sy*x + cy*y;
    const vy = cp*ry - sp*z, vz = sp*ry + cp*z;
    const depth = vy + dist;
    if (depth <= 1) continue;
    const f = 520/depth;
    const u = 320 + rx*f, v = 320 - vz*f;
    if (u<0||u>=640||v<0||v>=640) continue;
    const h = Math.max(0, Math.min(1, (z+2.2)/5));
    c3dC.fillStyle = 'rgb(' + (40+215*h|0) + ',' + (90+120*(1-h)|0) + ',255)';
    c3dC.fillRect(u, v, Math.max(1, 2.4*f/10), Math.max(1, 2.4*f/10));
  }
}

function render() { drawMap(cur); draw3d(cur);
  document.getElementById('frameno').textContent = cur + '/' + (T-1); seek.value = cur; }
seek.oninput = () => { cur = +seek.value; render(); };
document.getElementById('acc').onchange = render;
document.getElementById('play').onclick = () => {
  playing = !playing;
  document.getElementById('play').innerHTML = playing ? '&#10074;&#10074;' : '&#9654;';
};
setInterval(() => { if (playing) { cur = (cur + (+document.getElementById('speed').value)) % T; render(); } }, 66);
const c3 = document.getElementById('c3d');
let drag = null;
c3.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (drag) { yaw += (e.clientX-drag[0])*0.008; pitch += (e.clientY-drag[1])*0.008;
  pitch = Math.max(-1.5, Math.min(1.5, pitch)); drag=[e.clientX,e.clientY]; draw3d(cur); } };
c3.onwheel = e => { e.preventDefault(); dist = Math.max(8, Math.min(300, dist * (e.deltaY>0?1.12:0.89))); draw3d(cur); };
render();
</script></body></html>
"""
