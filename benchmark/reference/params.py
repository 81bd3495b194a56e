"""The named tensors of each reference network, and seeded weights for them.

Names are those the program's networks use for their parameters and
BatchNorm statistics, so that one dict of weights serves both sides. The
weights are drawn on the device from one generator in a few large calls.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _mlp(spec: Spec, name: str, cin: int, widths) -> int:
    for i, cout in enumerate(widths):
        spec.append((f"{name}.kernel_{i}", (cin, cout), "kernel"))
        spec.append((f"{name}.scale_{i}", (cout,), "scale"))
        spec.append((f"{name}.bias_{i}", (cout,), "bias"))
        spec.append((f"{name}.mean_{i}", (cout,), "mean"))
        spec.append((f"{name}.var_{i}", (cout,), "var"))
        cin = cout
    return cin


def _dense(spec: Spec, name: str, cin: int, cout: int) -> None:
    spec.append((f"{name}.weight", (cout, cin), "dense"))
    spec.append((f"{name}.bias", (cout,), "bias"))


def _cost_volume(spec: Spec, name: str, c1: int, c2: int, cv: Dict) -> None:
    d = cv["mlp1"][-1]
    _mlp(spec, f"{name}.PointMLP_0", 10 + c1 + c2, cv["mlp1"])
    _mlp(spec, f"{name}.PointMLP_1", 10, (d,))
    _mlp(spec, f"{name}.PointMLP_2", 2 * d, cv["mlp2"])
    _mlp(spec, f"{name}.PointMLP_3", 10, (d,))
    _mlp(spec, f"{name}.PointMLP_4", d + c1 + d, cv["mlp2"])


def _pose(spec: Spec, name: str, emb: int, hidden: int) -> None:
    _dense(spec, f"{name}.LinearHead_0.Dense_0", emb, hidden)
    _dense(spec, f"{name}.LinearHead_1.Dense_0", hidden, 4)
    _dense(spec, f"{name}.LinearHead_2.Dense_0", hidden, 3)


def pwclonet_spec(c: Dict) -> Spec:
    spec: Spec = []
    mlps = c["sa_mlps"]
    emb = c["embedding"]
    for i in range(4):
        _mlp(spec, f"SetConv_{i}.PointMLP_0", 3 + (3 if i == 0 else mlps[i - 1][-1]), mlps[i])
    c1, c2, c3, c4 = (m[-1] for m in mlps)
    _cost_volume(spec, "CostVolume_0", c3, c3, c["cost_volume"])
    _mlp(spec, "SetConv_4.PointMLP_0", 3 + emb, c["flow_encoding_mlp"])
    _mlp(spec, "FlowPredictor_0.PointMLP_0", c4 + emb, c["flow_predictor_mlp"])
    _pose(spec, "PoseCalculator_0", emb, c["pose_hidden"])
    r = c["refine"]
    cv = dict(c["cost_volume"], nsample=r["nsample"], nsample_q=r["nsample_q"])
    for k, fine in enumerate((c3, c2, c1)):
        name = f"PoseWarpRefinement_{k}"
        for j in range(2):
            _mlp(spec, f"{name}.SetUpConv_{j}.PointMLP_0", emb + 3, r["upconv_mlp"])
            _mlp(spec, f"{name}.SetUpConv_{j}.PointMLP_1", r["upconv_mlp"][-1] + fine,
                 r["upconv_post_mlp"])
        _cost_volume(spec, f"{name}.CostVolume_0", fine, fine, cv)
        _mlp(spec, f"{name}.FlowPredictor_0.PointMLP_0", fine + 2 * emb, c["flow_predictor_mlp"])
        if k < 2:
            _mlp(spec, f"{name}.FlowPredictor_1.PointMLP_0", fine + 2 * emb,
                 c["flow_predictor_mlp"])
        _pose(spec, f"{name}.PoseCalculator_0", emb, c["pose_hidden"])
    return spec


def semseg_spec(c: Dict) -> Spec:
    spec: Spec = []
    widths = [c["in_channels"] - 3]
    for i, st in enumerate(c["stages"]):
        widths.append(_mlp(spec, f"SetConvMSG_{i}.PointMLP_0", 3 + widths[-1], st["mlp"]))
    width = widths[-1]
    n = len(c["stages"])
    for j, level in enumerate(range(n - 1, -1, -1)):
        w = c["fp_width"] if level > 0 else c["head_width"]
        width = _mlp(spec, f"FeaturePropagation_{j}.PointMLP_0", width + widths[level], (w, w))
    _mlp(spec, "PointMLP_0", width, (c["head_width"],))
    _dense(spec, "Dense_0", c["head_width"], c["num_classes"])
    return spec


def spec_of(config: Dict) -> Spec:
    return {"pwclonet": pwclonet_spec, "pointnet2_semseg": semseg_spec}[config["model"]](config)


# (low, high) of the uniform draw of each kind; kernels are xavier-uniform
_RANGES = {"scale": (0.9, 1.1), "bias": (-0.05, 0.05), "mean": (-0.05, 0.05),
           "var": (0.8, 1.2)}


def make_weights(config: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every named tensor of the configuration's network, float32 on
    ``device``, from ``seed``: one uniform draw over all of them, then one
    affine map with a range per tensor."""
    spec = spec_of(config)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    lo, hi = [], []
    for _, shape, kind in spec:
        if kind in ("kernel", "dense"):
            cin, cout = (shape[0], shape[1]) if kind == "kernel" else (shape[1], shape[0])
            bound = (6.0 / (cin + cout)) ** 0.5
            lo.append(-bound)
            hi.append(bound)
        else:
            lo.append(_RANGES[kind][0])
            hi.append(_RANGES[kind][1])
    counts = torch.tensor(sizes, device=device)
    lo_t = torch.repeat_interleave(torch.tensor(lo, dtype=torch.float32, device=device), counts)
    hi_t = torch.repeat_interleave(torch.tensor(hi, dtype=torch.float32, device=device), counts)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * (hi_t - lo_t) + lo_t
    return {name: part.view(shape) for (name, shape, _), part in zip(spec, flat.split(sizes))}
