"""PWCLO-Net supervised multi-level loss with learned uncertainty weighting.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/losses.py``:

- rotation loss per level: ``mean ‖q̂/‖q̂‖ − q_gt‖₂``;
- translation loss per level: ``mean √((t̂−t_gt)² + 1e-10)`` element-wise;
- learned exponential weights shared across levels:
  ``L = l_t·e^{−s_t} + s_t + l_q·e^{−s_q} + s_q`` with init
  ``(s_t, s_q) = (0, −2.5)``;
- total: ``1.6·L4 + 0.8·L3 + 0.4·L2 + 0.2·L1`` with level 1 the finest.

The two ``s`` parameters live in the train state beside the network's
parameters and are optimized jointly with them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

LEVEL_WEIGHTS = (0.2, 0.4, 0.8, 1.6)  # levels 1..4 (fine → coarse)


@dataclasses.dataclass(frozen=True)
class PWCLONetLossConfig:
    with_exp_weights: bool = True
    init_weights: Tuple[float, float] = (0.0, -2.5)  # (s_trans, s_rot)
    fixed_weights: Tuple[float, float] = (1.0, 100.0)  # if not exp-weighted


def init_loss_params(config: PWCLONetLossConfig = PWCLONetLossConfig(),
                     device="cpu") -> Dict[str, torch.Tensor]:
    s_param = torch.tensor(config.init_weights, dtype=torch.float32, device=device)
    return {"s_param": s_param.requires_grad_()}


def _rot_loss(q_pred: torch.Tensor, q_gt: torch.Tensor) -> torch.Tensor:
    qn = q_pred / (torch.sqrt(torch.sum(q_pred * q_pred, dim=-1, keepdim=True) + 1e-10) + 1e-10)
    return torch.mean(torch.sqrt(torch.sum((qn - q_gt) ** 2, dim=-1) + 1e-10))


def _trans_loss(t_pred: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sqrt((t_pred - t_gt) ** 2 + 1e-10))


def pwclonet_loss(
    loss_params: Dict[str, torch.Tensor],
    pred_params: torch.Tensor,
    gt_params: torch.Tensor,
    config: PWCLONetLossConfig = PWCLONetLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``pred_params (B, 4, 7)`` (level-major, index 0 = finest),
    ``gt_params (B, 7)`` = (t, q_wxyz). Returns (scalar loss, log dict of
    detached 0-dim tensors)."""
    t_gt, q_gt = gt_params[:, :3], gt_params[:, 3:]
    log = {}
    total = 0.0
    for lvl in range(4):
        lt = _trans_loss(pred_params[:, lvl, :3], t_gt)
        lq = _rot_loss(pred_params[:, lvl, 3:], q_gt)
        if config.with_exp_weights:
            s = loss_params["s_param"]
            level_loss = lt * torch.exp(-s[0]) + s[0] + lq * torch.exp(-s[1]) + s[1]
        else:
            w = config.fixed_weights
            level_loss = lt * w[0] + lq * w[1]
        total = total + LEVEL_WEIGHTS[lvl] * level_loss
        log[f"loss_trans_l{lvl + 1}"] = lt
        log[f"loss_rot_l{lvl + 1}"] = lq
        log[f"loss_l{lvl + 1}"] = level_loss
    log["loss"] = total
    if config.with_exp_weights:
        log["s_param_trans"] = loss_params["s_param"][0]
        log["s_param_rot"] = loss_params["s_param"][1]
    # copies: the entries that are views of s_param must not follow its updates
    return total, {k: v.detach().clone() for k, v in log.items()}
