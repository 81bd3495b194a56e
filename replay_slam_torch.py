#!/usr/bin/env python
"""Re-run a saved SLAM experiment of ``run_slam_torch.py`` from its persisted
config, with the PyTorch port.

Usage::

    python replay_slam_torch.py <run_dir> [overrides...] [start=N] [length=M]

Reads ``<run_dir>/config.yaml``, applies any ``key=value`` overrides,
optionally windows the sequence (``start``/``length``), and re-executes into
``<run_dir>/replay``, as ``replay_slam.py`` does: with the default ICP
odometry and the saved loop-closure and back-end switches, on the saved
``device`` (the card unless the run or an override says ``device=cpu``).
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    import yaml

    from run_slam_torch import RunConfig, build_sources
    from pwclonet_pylidarslam_torch.slam.pipeline import SLAMConfig
    from pwclonet_pylidarslam_torch.slam.runner import SLAMRunner, SLAMRunnerConfig
    from pwclonet_pylidarslam_torch.utils.config import apply_overrides, from_dict

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    run_dir = argv[0]
    with open(os.path.join(run_dir, "config.yaml")) as f:
        saved = yaml.safe_load(f)["config"]

    window = {}
    overrides = []
    for a in (a for a in argv[1:] if "=" in a):
        k, v = a.split("=", 1)
        if k in ("start", "length"):
            window[k] = int(v)
        else:
            overrides.append(a)
    config = from_dict(RunConfig, apply_overrides(saved, overrides))

    sources = build_sources(config)
    if window:
        start = window.get("start", 0)
        length = window.get("length")

        class _Window:
            def __init__(self, src):
                self.src = src
                self.n = len(src) - start if length is None else min(length, len(src) - start)

            def __len__(self):
                return self.n

            def scan(self, i):
                return self.src.scan(start + i)

            def ground_truth(self):
                gt = self.src.ground_truth()
                return None if gt is None else gt[start : start + self.n]

        sources = {k: _Window(v) for k, v in sources.items()}

    runner = SLAMRunner(
        SLAMRunnerConfig(
            slam=SLAMConfig(
                with_loop_closure=config.with_loop_closure,
                with_backend=config.with_backend,
            ),
            log_dir=os.path.join(run_dir, "replay"),
        ),
        device=config.device,
    )
    results = runner.run(sources)
    for name, md in results.items():
        if md:
            print(f"{name}: ATE={md['ATE']:.4f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
