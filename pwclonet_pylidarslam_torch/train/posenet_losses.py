"""PoseResNet losses: supervised pose regression and unsupervised
point-to-plane.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/train/posenet_losses.py``:

- :func:`pose_supervision_loss`: l1 or l2 on (t, euler angles, in degrees
  by default) against the ground-truth matrices, with optional learned
  exponential weighting ``l_t·e^{−s_t} + s_t + l_r·e^{−s_r} + s_r``;
- :func:`point_to_plane_loss`: transform the target vertex map by the
  predicted pose, re-project it through the z-buffer, and take the robust
  point-to-plane residual against the reference vertex and normal maps.
  The z-buffer's winner selection is a hard argmin; gradients flow through
  the winning points' coordinates (the ``torch.gather`` of
  ``core.projection.zbuffer_scatter``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from pwclonet_pylidarslam_torch.core import optimization as opt, se3
from pwclonet_pylidarslam_torch.core.geometry import compute_normal_map
from pwclonet_pylidarslam_torch.core.projection import SphericalProjector, vmap_to_points


@dataclasses.dataclass(frozen=True)
class SupervisedLossConfig:
    loss_option: str = "l1"  # l1 | l2
    degrees: bool = True  # compare rotations in euler degrees
    with_exp_weights: bool = True
    init_weights: Tuple[float, float] = (0.0, -3.0)
    fixed_weights: Tuple[float, float] = (1.0, 1.0)


def init_supervised_loss_params(config: SupervisedLossConfig = SupervisedLossConfig(),
                                device="cpu") -> Dict[str, torch.Tensor]:
    s_param = torch.tensor(config.init_weights, dtype=torch.float32, device=device)
    return {"s_param": s_param.requires_grad_()}


def pose_supervision_loss(
    loss_params: Dict[str, torch.Tensor],
    pred_params: torch.Tensor,
    gt_pose: torch.Tensor,
    config: SupervisedLossConfig = SupervisedLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``pred_params (B, 6)`` = (t, euler) against matrices ``gt_pose (B, 4, 4)``."""

    def _loss(x, y):
        if config.loss_option == "l1":
            return torch.mean(torch.sum(torch.abs(x - y), dim=-1))
        return torch.mean(torch.sum((x - y) ** 2, dim=-1))

    gt_params = se3.pose_to_params_euler(gt_pose)
    scale = 180.0 / math.pi if config.degrees else 1.0
    loss_rot = _loss(pred_params[:, 3:] * scale, gt_params[:, 3:] * scale)
    loss_trans = _loss(pred_params[:, :3], gt_params[:, :3])
    log = {"loss_rot": loss_rot, "loss_trans": loss_trans}
    if config.with_exp_weights:
        s = loss_params["s_param"]
        loss = loss_trans * torch.exp(-s[0]) + s[0] + loss_rot * torch.exp(-s[1]) + s[1]
        log["s_param_trans"] = s[0]
        log["s_param_rot"] = s[1]
    else:
        w = config.fixed_weights
        loss = loss_trans * w[0] + loss_rot * w[1]
    log["loss"] = loss
    return loss, log


@dataclasses.dataclass(frozen=True)
class PointToPlaneLossConfig:
    scheme: str = "geman_mcclure"
    sigma: float = 0.5
    normal_kernel_size: int = 5


def point_to_plane_loss(
    projector: SphericalProjector,
    vm_target: torch.Tensor,
    vm_reference: torch.Tensor,
    pred_params: torch.Tensor,
    nm_reference: Optional[torch.Tensor] = None,
    config: PointToPlaneLossConfig = PointToPlaneLossConfig(),
) -> torch.Tensor:
    """Unsupervised ICP-style loss of consecutive vertex maps
    ``vm_target``/``vm_reference (B, H, W, 3)`` and the predicted (t, euler)
    ``pred_params (B, 6)`` mapping target into reference coordinates."""
    if nm_reference is None:
        nm_reference = compute_normal_map(vm_reference, config.normal_kernel_size)
    pose = se3.params_to_pose_euler(pred_params)
    tgt_pts, tgt_mask = vmap_to_points(vm_target)
    transformed = se3.transform(pose, tgt_pts) * tgt_mask[..., None]
    vm_transformed = projector.build_projection_map(transformed)

    pc_t, m_t = vmap_to_points(vm_transformed)
    pc_r, m_r = vmap_to_points(vm_reference)
    nm_r, m_n = vmap_to_points(nm_reference)
    mask = m_t * m_r * m_n
    residuals = mask * torch.abs(torch.sum((pc_r - pc_t) * nm_r, dim=-1))
    cost = opt.robust_cost(residuals, config.scheme, config.sigma)
    return torch.mean(torch.sum(cost * mask, dim=1) / torch.clamp_min(torch.sum(mask, dim=1), 1.0))
