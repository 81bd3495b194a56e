"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's, each held to its limit.

Training (three steps from the same weights and batches):

- ``loss``: the largest ``|L − L_ref| / |L_ref|`` over the steps, and
  ``loss1`` that of the first step alone (a cell whose later steps swing
  with round-off compares this one; its workload file's limits say which);
- ``grad``: the first gradient as the optimizer holds it, by the worst leaf:
  ``|‖g‖ − ‖g_ref‖| / max(‖g_ref‖, median leaf ‖g_ref‖)``;
- ``change``: the parameters' change over the three steps, by the worst
  leaf, the same way; leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone under Adam and are left out.

Answers checked one by one (poses): each relative pose's gap, the widest of
the rotation's entries and the translation's over ``max(1, |t_ref|)``; the
odometry cell reads the mean, the median and the 99th percentile of a
sample's gaps, and its workload file's limits say which it compares.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

ROUNDOFF_LEAF = 1e-3  # of the median leaf's reference gradient


def loss_gap(losses: Sequence[float], ref: Sequence[float]) -> float:
    if len(losses) != len(ref) or not len(ref):
        return float("inf")
    gaps = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf") for a, b in zip(losses, ref)]
    return float(max(gaps))


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> float:
    """Worst leaf of ``|‖x‖ − ‖x_ref‖| / max(‖x_ref‖, median leaf ‖x_ref‖)``
    over the leaves ``keep``; a missing leaf counts as infinitely far."""
    if any(k not in prog for k in keep):
        return float("inf")
    p, r = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    median = float(np.median(list(r.values())))
    worst = 0.0
    for k in keep:
        denom = max(r[k], median)
        gap = abs(p[k] - r[k]) / denom if denom > 0 else (0.0 if p[k] == 0 else float("inf"))
        if not np.isfinite(p[k]):
            gap = float("inf")
        worst = max(worst, gap)
    return worst


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move by round-off alone."""
    norms = _norms(ref_grad)
    median = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= ROUNDOFF_LEAF * median]


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses": [3 floats], "grad": {leaf: tensor},
    "change": {leaf: tensor}}``."""
    moving = moving_leaves(ref["grad"])
    return {"loss": loss_gap(prog["losses"], ref["losses"]),
            "loss1": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad": leaf_gap(prog["grad"], ref["grad"], list(ref["grad"])),
            "change": leaf_gap(prog["change"], ref["change"], moving)}


def batch_gap(prog: Sequence[Dict], ref: Sequence[Dict]) -> float:
    """The widest element gap between two lists of batches (inf where their
    keys or shapes differ)."""
    worst = 0.0 if len(prog) == len(ref) else float("inf")
    for a, b in zip(prog, ref):
        for k in b:
            x, y = np.asarray(a.get(k)), np.asarray(b[k])
            if x.shape != y.shape:
                return float("inf")
            worst = max(worst, float(np.max(np.abs(x.astype(np.float64) - y)))) if y.size else worst
    return worst


def pose_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each relative pose's gap ``(P,)`` between ``(P, 4, 4)`` stacks; inf
    where the program's is not finite or the stacks differ in length."""
    if prog.shape != ref.shape:
        return np.full(max(len(ref), 1), np.inf)
    rot = np.abs(prog[:, :3, :3] - ref[:, :3, :3]).max(axis=(1, 2))
    scale = np.maximum(1.0, np.abs(ref[:, :3, 3]).max(axis=1))
    trans = np.abs(prog[:, :3, 3] - ref[:, :3, 3]).max(axis=1) / scale
    gaps = np.maximum(rot, trans)
    return np.where(np.all(np.isfinite(prog), axis=(1, 2)), gaps, np.inf)


def pose_readings(gaps: np.ndarray) -> Dict[str, float]:
    """The mean, the median and the 99th percentile of a sample's pose gaps."""
    return {"pose_mean": float(np.mean(gaps)), "pose_median": float(np.median(gaps)),
            "pose_p99": float(np.percentile(gaps, 99))}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing one fails)."""
    return all(k in readings and np.isfinite(readings[k]) and readings[k] <= v
               for k, v in limits.items())


def train_detail(prog: Dict, ref: Dict, worst: int = 5) -> Dict:
    """Per-step losses of both sides and the worst leaves of each gap."""
    out = {"losses": prog["losses"], "ref_losses": ref["losses"],
           "left_out_of_change": sorted(set(ref["grad"]) - set(moving_leaves(ref["grad"])))}
    for key in ("grad", "change"):
        keep = list(ref["grad"]) if key == "grad" else moving_leaves(ref["grad"])
        p, r = _norms({k: prog[key][k] for k in keep}), _norms({k: ref[key][k] for k in keep})
        median = float(np.median(list(r.values())))
        rows = sorted(((abs(p[k] - r[k]) / max(r[k], median), k, p[k], r[k]) for k in keep),
                      reverse=True)[:worst]
        out[key] = [[k, g, a, b] for g, k, a, b in rows]
        out[key + "_median"] = median
    return out
