"""Classic ICP odometry on the KITTI-profile worlds of ``config=kitti_batched``:
the reference (JAX, on the CPU) and the port (on ``--device``) over the same
scans, ``kitti_preset(n_frames, seed=s, num_points=8192)`` cast by the
reference's generator, with the ``ICPConfig`` that both ``run_slam.py`` and
``run_slam_torch.py`` build for ``batched=true`` (``num_points=8192``, the BEV
prior off unless ``--bev``). One JSON line a world and implementation::

    JAX_PLATFORMS=cpu python tests/icp_world_ate.py --seeds 0,4,8
    JAX_PLATFORMS=cpu python tests/icp_world_ate.py --seeds 8 --association voxel --bev

Keys: ``impl``, ``seed``, ``ATE`` (m a frame, the port's
``evaluation/metrics.py::metrics_dict`` for both), ``tr_err`` (%, over
5/10/20 m segments, as ``chip_smoke.py`` phase 13), ``final_error_m`` (the
last frame's translation error), ``seconds``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

T_REL_SEGMENTS = (5.0, 10.0, 20.0)


def run_reference(scans: np.ndarray, association: str, bev: bool) -> np.ndarray:
    from pwclonet_pylidarslam_tpu.slam.icp_odometry import ICPConfig, ICPOdometry

    odo = ICPOdometry(ICPConfig(num_points=8192, association=association, bev_bootstrap=bev))
    odo.init()
    return np.asarray(odo.process_sequence(scans))


def run_port(scans: np.ndarray, association: str, bev: bool, device: str) -> np.ndarray:
    from pwclonet_pylidarslam_torch.slam.icp_odometry import ICPConfig, ICPOdometry

    odo = ICPOdometry(ICPConfig(num_points=8192, association=association, bev_bootstrap=bev),
                      device=device)
    odo.init()
    return np.asarray(odo.process_sequence(scans))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="0,4,8")
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--association", default="projective")
    parser.add_argument("--bev", action="store_true")
    parser.add_argument("--impl", default="ref,port", help="ref, port or both")
    parser.add_argument("--device", default="cpu", help="the port's device")
    parser.add_argument("--threads", type=int, default=4, help="torch threads of the port")
    args = parser.parse_args()

    import torch

    from pwclonet_pylidarslam_tpu.data.synthetic import generate_sequence, kitti_preset
    from pwclonet_pylidarslam_torch.evaluation.metrics import metrics_dict

    torch.set_num_threads(args.threads)
    for seed in (int(s) for s in args.seeds.split(",")):
        scans, gt = generate_sequence(kitti_preset(args.frames, seed=seed, num_points=8192))
        scans = scans.astype(np.float32)
        for impl in args.impl.split(","):
            t0 = time.perf_counter()
            if impl == "ref":
                poses = run_reference(scans, args.association, args.bev)
            else:
                poses = run_port(scans, args.association, args.bev, args.device)
            seconds = time.perf_counter() - t0
            md = metrics_dict(poses.astype(np.float64), gt, segments=T_REL_SEGMENTS)
            print(json.dumps({
                "impl": impl, "seed": seed, "association": args.association, "bev": args.bev,
                "device": "cpu" if impl == "ref" else args.device, "ATE": md["ATE"],
                "tr_err": md["tr_err"],
                "final_error_m": float(np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3])),
                "seconds": seconds,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
