"""Training loss: (1-l)*L1 + l*(1-SSIM) with mask compositing, plus the
optional scale-anisotropy regularizer; counterpart of
``easy_gaussian_splatting_tpu/models/loss.py``."""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.clip import maximum
from ..ops.ssim import ssim


def composite_mask(
    render_img: torch.Tensor,  # [H, W, 3]
    gt_img: torch.Tensor,  # [H, W, 3]
    mask: torch.Tensor,  # [H, W]; 1 = masked-out object
) -> torch.Tensor:
    """``mask * gt + (1 - mask) * render``: masked pixels give no gradient."""
    m = mask[..., None]
    return m * gt_img + (1.0 - m) * render_img


def scale_regularization(
    log_scales: torch.Tensor,  # [C, 3]
    alive: torch.Tensor,  # [C] bool
    max_scale_ratio: float,
) -> torch.Tensor:
    """Mean over alive Gaussians of ``max(max_scale / min_scale, R) - R``."""
    scales = torch.exp(log_scales)
    ratio = scales.amax(dim=-1) / scales.amin(dim=-1)
    excess = maximum(ratio, max_scale_ratio) - max_scale_ratio
    n_alive = maximum(alive.to(torch.float32).sum(), 1.0)
    return torch.where(alive, excess, torch.zeros_like(excess)).sum() / n_alive


def loss_dict(
    render_img: torch.Tensor,
    gt_img: torch.Tensor,
    mask: torch.Tensor,
    lambda_ssim: float,
    log_scales: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    use_scale_regularization: bool = False,
    max_scale_ratio: float = 10.0,
    lambda_scale: float = 0.1,
) -> Dict[str, torch.Tensor]:
    render_img = composite_mask(render_img, gt_img, mask)
    l1 = torch.mean(torch.abs(render_img - gt_img))
    ssim_loss = 1.0 - ssim(gt_img, render_img)
    out = {"l1": l1, "ssim": ssim_loss}
    total = (1.0 - lambda_ssim) * l1 + lambda_ssim * ssim_loss
    if use_scale_regularization:
        reg = scale_regularization(log_scales, alive, max_scale_ratio)
        out["scale_reg"] = reg
        total = total + lambda_scale * reg
    out["total"] = total
    return out
