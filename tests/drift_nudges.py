"""The drift scenario's spread: ``slam/drift_injection.py::run_drift_scenario``
(back end on) over its scans moved by ``k`` float32 ulp, for the reference
(JAX, on the CPU) or the port (on ``--device``).

The scenario's first ICP step (identity prior, 1.6 m of motion) lands short
on some of these inputs, in both implementations, and no loop constraint
observes that offset; this script measures how often, and how far the final
error moves with it. One JSON line a ``k``::

    JAX_PLATFORMS=cpu python tests/drift_nudges.py --impl ref --k=-2,-1,0,1,2
    python tests/drift_nudges.py --impl port --device cuda --k=0,1
    python tests/drift_nudges.py --impl port --first-step --k=-12:12

Keys: ``final_on`` (mean translation error of the last 10 frames, m, the
quantity ``tests/test_pipeline.py::test_loop_backend_reduces_drift`` gates),
``first_step_error`` (frame 1's error, m), ``final_on_anchored`` (the same
mean once both trajectories are aligned at frame 1), ``constraints`` and
``seconds``. ``--first-step`` runs the scenario's odometry over frames 0
and 1 only and reports ``first_step_error``. ``--accurate-projection``
takes the spherical projection of each scan's normal map (``atan2``,
``asin`` and the range) in float64, rounded to float32 after, in either
implementation.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def nudge(scans: np.ndarray, k: int) -> np.ndarray:
    """Every non-zero coordinate moved by ``k`` float32 ulp (up for k > 0)."""
    for _ in range(abs(k)):
        scans = np.where(scans != 0, np.nextafter(scans, np.float32(np.sign(k) * np.inf)),
                         0.0).astype(np.float32)
    return scans


def anchored_final(poses: np.ndarray, gt: np.ndarray, anchor: int = 1) -> float:
    aligned = gt[anchor] @ np.linalg.inv(poses[anchor]) @ poses
    return float(np.linalg.norm(aligned[-10:, :3, 3] - gt[len(poses) - 10: len(poses), :3, 3],
                                axis=1).mean())


def _pixel_coords64(points: np.ndarray, height, width, min_fov, max_fov):
    """``core/projection.py::spherical_pixel_coords`` in float64, rounded
    to float32."""
    p = np.asarray(points, np.float64)
    r = np.linalg.norm(p, axis=-1)
    valid = r > 0.0
    r_safe = np.where(valid, r, 1e-3)
    theta = -np.arctan2(p[..., 1], p[..., 0])
    phi = np.arcsin(np.clip(p[..., 2] / r_safe, -1.0, 1.0))
    fov_down = abs(math.radians(max_fov))
    fov = fov_down + abs(math.radians(min_fov))
    col = np.where(valid, 0.5 * (theta / math.pi + 1.0) * width, -1.0)
    row = np.where(valid, (1.0 - (phi + fov_down) / fov) * height, -1.0)
    return tuple(x.astype(np.float32) for x in (row, col, np.where(valid, r, 0.0)))


def _accurate_projection(impl: str) -> None:
    """Route the scan's own projection (its normal map and each point's
    pixel) through :func:`_pixel_coords64`."""
    if impl == "ref":
        import jax
        import jax.numpy as jnp
        from pwclonet_pylidarslam_tpu.core import projection

        def coords(points, height, width, min_fov, max_fov):
            shape = jax.ShapeDtypeStruct(points.shape[:-1], jnp.float32)
            return jax.pure_callback(
                lambda p: _pixel_coords64(p, height, width, min_fov, max_fov),
                (shape, shape, shape), points)

        projection.spherical_pixel_coords = coords
    else:
        import torch
        from pwclonet_pylidarslam_torch.slam import icp_odometry

        def coords(points, height, width, min_fov, max_fov):
            out = _pixel_coords64(points.cpu().numpy(), height, width, min_fov, max_fov)
            return tuple(torch.from_numpy(x).to(points.device) for x in out)

        icp_odometry.spherical_pixel_coords = coords


def _modules(impl: str):
    if impl == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from pwclonet_pylidarslam_tpu.data import synthetic
        from pwclonet_pylidarslam_tpu.slam import drift_injection, icp_odometry
    else:
        from pwclonet_pylidarslam_torch.data import synthetic
        from pwclonet_pylidarslam_torch.slam import drift_injection, icp_odometry
    return synthetic, drift_injection, icp_odometry


def first_step(impl: str, k: int, device: str = "cpu") -> dict:
    """Frames 0 and 1 of the scenario's biased ICP odometry."""
    synthetic, di, icp = _modules(impl)
    kwargs = {} if impl == "ref" else {"device": device}
    scans, gt = synthetic.generate_sequence(synthetic.SyntheticSequenceConfig(
        n_frames=80, trajectory="there_and_back", speed=1.6, seed=5, num_points=2048), **kwargs)
    odo = di.DriftingICPOdometry(icp.ICPConfig(num_points=2048, initial_assoc_distance=8.0),
                                 di.yaw_bias(), **kwargs)
    odo.init()
    s = nudge(scans[:2], k)
    odo.process_next_frame(s[0])
    pose = np.asarray(odo.process_next_frame(s[1]))
    return {"impl": impl, "device": device, "k": k,
            "first_step_error": float(np.linalg.norm(pose[:3, 3] - gt[1, :3, 3]))}


def scenario(impl: str, k: int, device: str = "cpu") -> dict:
    synthetic, di, _ = _modules(impl)
    kwargs = {} if impl == "ref" else {"device": device}
    generate = synthetic.generate_sequence
    truth = []

    def nudged(cfg, **kw):
        scans, gt = generate(cfg, **kw)
        truth.append(gt)
        return nudge(scans, k), gt

    synthetic.generate_sequence = nudged
    try:
        t = time.time()
        slam, err = di.run_drift_scenario(with_backend=True, **kwargs)
        seconds = time.time() - t
    finally:
        synthetic.generate_sequence = generate
    return {"impl": impl, "device": device, "k": k, "final_on": float(err[-10:].mean()),
            "first_step_error": float(err[1]),
            "final_on_anchored": anchored_final(np.asarray(slam.absolute_poses()), truth[0]),
            "constraints": len(slam.loop_closure.constraints), "seconds": seconds}


def _ks(text: str):
    if ":" in text:
        lo, hi = (int(x) for x in text.split(":"))
        return list(range(lo, hi + 1))
    return [int(x) for x in text.split(",")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("ref", "port"), required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--k", default="0", help="ulp counts: 'a,b,c' or 'lo:hi'")
    ap.add_argument("--first-step", action="store_true")
    ap.add_argument("--accurate-projection", action="store_true")
    args = ap.parse_args()
    if args.accurate_projection:
        _modules(args.impl)
        _accurate_projection(args.impl)
    run = first_step if args.first_step else scenario
    for k in _ks(args.k):
        out = run(args.impl, k, args.device)
        out["accurate_projection"] = args.accurate_projection
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
