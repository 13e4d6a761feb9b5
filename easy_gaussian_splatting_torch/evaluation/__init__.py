"""Evaluation: PSNR/SSIM/LPIPS metrics and the evaluator loop."""

from .evaluator import Evaluator
from .metrics import psnr

__all__ = ["psnr", "Evaluator"]
