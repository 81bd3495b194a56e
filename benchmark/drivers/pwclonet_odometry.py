"""PWCLO-Net odometry over a recorded drive:
``PWCLONetOdometry.process_sequence`` on consecutive chunks, closed loop,
the drive replayed from its start (``init()``) when it ends.

Set-up casts the drive, builds the odometry with the benchmark's weights and
runs the drive through once, so that every shape the window sees (the first
chunk has one pair fewer) is warm. Every call's poses are kept; the check
draws a sample of the window's calls from the seed, one of them a drive's
first chunk, and compares each relative pose the program returned with the
reference's forward on the same scans, prepared as the program prepares
them. The numbers are the mean and the median of the poses' gaps and their
99th percentile (``compare.pose_readings``): a rare kNN near-tie that flips
after the warp moves one pose by up to ~0.02 in sound runs, as far as the
control's nearest pose, while the control moves them all; a pose altered
where it is produced moves the mean and the tail.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.driver import Base, Done, Phases
from benchmark.reference import nn as F, params, pwclonet as ref_net, world


def prepare(points: np.ndarray, n: int) -> np.ndarray:
    """A scan as the odometry takes it: points at the origin dropped, then
    ``n`` drawn without replacement (seeded by the count), or all of them
    and the rest drawn with replacement (seed 0)."""
    pts = points[np.linalg.norm(points, axis=-1) > 1e-6]
    if len(pts) >= n:
        pts = pts[np.random.default_rng(len(pts)).choice(len(pts), n, replace=False)]
    else:
        extra = np.random.default_rng(0).choice(len(pts), n - len(pts), replace=True)
        pts = np.concatenate([pts, pts[extra]])
    return pts.astype(np.float32)


def relative(poses: np.ndarray) -> np.ndarray:
    """``inv(P_i) @ P_{i+1}`` of consecutive absolute poses ``(T, 4, 4)``."""
    return np.linalg.inv(poses[:-1]) @ poses[1:]


class Driver(Base):
    fused = True

    def __init__(self, config: Dict, workload: Dict, seed: int, device: torch.device):
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.chunk = workload["chunk"]
        self.batch = self.chunk
        self.phases = Phases()

    def setup(self) -> None:
        from pwclonet_pylidarslam_torch.models import PWCLONetConfig
        from pwclonet_pylidarslam_torch.slam.deep_odometry import (
            DeepOdometryConfig,
            PWCLONetOdometry,
        )

        c, inp = self.config, self.config["input"]
        sensor = world.Sensor(inp["num_beams"], inp["num_cols"], inp["fov_up_deg"],
                              inp["fov_down_deg"], inp["noise_std"], inp["dropout"])
        with self.phases("drives"):
            self.scans, _ = world.make_drive(sensor, self.workload["frames"], self.seed,
                                             self.device)
        self.n_chunks = len(self.scans) // self.chunk
        with self.phases("model"):
            self.weights = params.make_weights(c, self.seed, self.device)
            model = PWCLONetConfig(num_points=c["num_points"],
                                   sa_npoints=tuple(c["sa_npoints"]),
                                   sa_nsamples=tuple(c["sa_nsamples"]),
                                   sa_mlps=tuple(tuple(m) for m in c["sa_mlps"]),
                                   fused_eval=self.workload["fused_eval"])
            self.odo = PWCLONetOdometry({"model": self.weights},
                                        DeepOdometryConfig(model=model,
                                                           num_points=c["num_points"]),
                                        device=self.device)
        self.next_chunk = self.n_chunks
        # (chunk index, pose before the call, the call's poses) of each call
        # after the warm-up
        self.record: Optional[List[Tuple[int, np.ndarray, np.ndarray]]] = None
        with self.phases("warm_up"):  # the drive once
            for _ in range(self.n_chunks):
                self.call()
        self.record = []

    def call(self) -> Done:
        if self.next_chunk == self.n_chunks:
            self.odo.init()
            self.next_chunk = 0
        i = self.next_chunk
        before = self.odo.state_pose.copy()
        out = self.odo.process_sequence(self.scans[i * self.chunk:(i + 1) * self.chunk])
        self.next_chunk += 1
        if self.record is not None:
            self.record.append((i, before, out))
        pairs = self.chunk - 1 if i == 0 else self.chunk
        return Done(len(out), pairs, bool(np.all(np.isfinite(out))))

    def stretch(self, spans):
        pairs = 0
        for _ in range(self.workload["stretch_calls"]):
            with spans.span("bench.call"):
                pairs += self.call().work_units
        return self.workload["stretch_calls"], pairs

    def free(self) -> None:
        del self.odo

    # ------------------------------------------------------------ check

    def sample(self) -> List[int]:
        """Indices of the calls to check: one first chunk, the rest drawn."""
        rng = np.random.default_rng((self.seed, 17))
        n = len(self.record)
        firsts = [k for k, r in enumerate(self.record) if r[0] == 0]
        picks = [int(rng.choice(firsts))] if firsts else []
        others = [k for k in range(n) if k not in picks]
        want = min(self.workload["checked_calls"] - len(picks), len(others))
        picks += [int(k) for k in rng.choice(others, want, replace=False)]
        return sorted(picks)

    def pairs(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(cur, prev)`` prepared scans of chunk ``i``'s pairs."""
        n = self.config["num_points"]
        lo = i * self.chunk
        first = max(lo - 1, 0)
        prepared = np.stack([prepare(s, n) for s in self.scans[first: lo + self.chunk]])
        return prepared[1:], prepared[:-1]

    @torch.no_grad()
    def reference_rel(self, i: int, precision: str = "float32") -> np.ndarray:
        cur, prev = self.pairs(i)
        net = ref_net.Net(self.config, self.weights, precision, train=False)
        x1 = torch.from_numpy(cur).to(self.device)
        x2 = torch.from_numpy(prev).to(self.device)
        out = []
        step = self.workload["reference_block"]
        for lo in range(0, len(cur), step):
            p = net(x1[lo: lo + step], x2[lo: lo + step])[:, 0]
            out.append(F.params_to_pose(p.double()).cpu().numpy())
        return np.concatenate(out)

    def program_rel(self, k: int) -> np.ndarray:
        i, before, out = self.record[k]
        if i == 0:
            return relative(out)
        return relative(np.concatenate([before[None], out]))

    def gaps(self, precision: str = "") -> np.ndarray:
        """Each sampled pose's gap to the reference: the program's, or with
        ``precision`` the reference's own in that precision."""
        out = []
        for k in self.sample():
            i = self.record[k][0]
            got = self.reference_rel(i, precision) if precision else self.program_rel(k)
            out.append(compare.pose_gaps(got, self.reference_rel(i)))
        return np.concatenate(out)

    def readings(self) -> Dict[str, float]:
        return compare.pose_readings(self.gaps())

    def control_readings(self, precision: str) -> Dict[str, float]:
        return compare.pose_readings(self.gaps(precision))

