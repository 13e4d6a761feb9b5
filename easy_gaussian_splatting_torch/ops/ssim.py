"""SSIM (11x11 Gaussian window, sigma 1.5, valid padding); counterpart of
``easy_gaussian_splatting_tpu/ops/ssim.py``.

The separable Gaussian blur is two banded-matrix products, ``B_h @ X @
B_w^T``, as in the JAX package: a plain large product, left to
``torch.matmul`` in full f32 (TF32 is off package-wide), whose autograd
transpose is again matmuls."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _blur_matrix(size: int, kernel_size: int, sigma: float) -> np.ndarray:
    """[size - k + 1, size] banded matrix applying a VALID 1-D Gaussian."""
    ax = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    g = g / g.sum()
    out_size = size - kernel_size + 1
    if out_size <= 0:
        raise ValueError(f"image size {size} smaller than SSIM kernel {kernel_size}")
    mat = np.zeros((out_size, size), np.float32)
    for i in range(out_size):
        mat[i, i : i + kernel_size] = g
    return mat


@functools.lru_cache(maxsize=16)
def _blur_tensor(size: int, kernel_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The blur matrix on ``device``, uploaded once per shape."""
    return torch.as_tensor(_blur_matrix(size, kernel_size, sigma)).to(device)


def _blur(x: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """x: [C, H, W] -> [C, H', W'] valid separable Gaussian blur."""
    return torch.matmul(torch.matmul(bh, x), bw.T)


def ssim(
    img_a: torch.Tensor,  # [H, W, C] in [0, data_range]
    img_b: torch.Tensor,  # [H, W, C]
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM between two images. Differentiable."""
    h, w = img_a.shape[0], img_a.shape[1]
    bh = _blur_tensor(h, kernel_size, sigma, img_a.device)
    bw = _blur_tensor(w, kernel_size, sigma, img_a.device)
    a = torch.movedim(img_a, -1, 0)  # [C, H, W]
    b = torch.movedim(img_b, -1, 0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    # one blur over the 5 statistic maps
    stats = torch.cat([a, b, a * a, b * b, a * b], dim=0)
    blurred = _blur(stats, bh, bw)
    c = a.shape[0]
    mu_a = blurred[0:c]
    mu_b = blurred[c : 2 * c]
    mu_aa = blurred[2 * c : 3 * c]
    mu_bb = blurred[3 * c : 4 * c]
    mu_ab = blurred[4 * c : 5 * c]

    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b

    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
