"""Image quality metrics; counterpart of
``easy_gaussian_splatting_tpu/evaluation/metrics.py``: PSNR and SSIM with
``data_range=1.0``; SSIM is the loss's (``ops/ssim.py``), LPIPS lives in
``lpips.py``."""

from __future__ import annotations

import torch

from ..ops.ssim import ssim  # re-exported for the evaluator

__all__ = ["psnr", "ssim"]


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole image (all channels)."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
