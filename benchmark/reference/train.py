"""Plain reference of the train step: render (``render.py``), the loss
``(1 - l) L1 + l (1 - SSIM)`` (SSIM with an 11-tap Gaussian window, sigma
1.5, valid padding, as Kerbl et al. 2023 train), its gradient, and Adam
with one learning rate a parameter group (betas 0.9 / 0.999, eps 1e-8
after the bias-corrected square root).

The per-Gaussian math, the loss and Adam run in ``hi`` (float64 for the
reference), and the gradient is taken back through them; compositing and
its gradient run in float32 on the ``hi`` values rounded to it, over the
tile lists binned from the Gaussians as ``program32.py`` rounds them (the
binning's decisions only). The control (``tf32=True``, ``hi`` float32)
rounds every matrix product's operands to TF32: the projection's, the
compositing's and the SSIM window's. Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import render as R
from .program32 import binning32

LEAVES = ("means", "log_scales", "quats", "sh_0", "sh_rest", "logit_opacities")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _blur_matrix(size: int, dtype, device, taps: int = 11, sigma: float = 1.5):
    ax = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    g /= g.sum()
    mat = np.zeros((size - taps + 1, size))
    for i in range(size - taps + 1):
        mat[i, i:i + taps] = g
    return torch.as_tensor(mat, dtype=dtype, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images in [0, 1]."""
    h, w = a.shape[0], a.shape[1]
    bh = _blur_matrix(h, a.dtype, a.device)
    bw = _blur_matrix(w, a.dtype, a.device)
    a, b = a.permute(2, 0, 1), b.permute(2, 0, 1)
    maps = torch.cat([a, b, a * a, b * b, a * b])  # [15, H, W]
    blurred = R.matmul(R.matmul(bh, maps, tf32), bw.T, tf32)
    mu_a, mu_b, aa, bb, ab = blurred.split(3)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    var_a, var_b, cov = aa - mu_a * mu_a, bb - mu_b * mu_b, ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return (num / den).mean()


def loss(image: torch.Tensor, target: torch.Tensor, lambda_ssim: float, tf32: bool = False,
         rows: int | None = None) -> torch.Tensor:
    """The train loss of a rendered [H, W, 3] image against its target;
    ``rows`` keeps only the first rows of both (a fault the correctness
    test plants: half of the batch left out)."""
    if rows is not None:
        image, target = image[:rows], target[:rows]
    l1 = torch.abs(image - target).mean()
    return (1.0 - lambda_ssim) * l1 + lambda_ssim * (1.0 - ssim(target, image, tf32))


def adam(p, m, v, g, t, lr: float):
    """One Adam update at group step ``t`` (after the increment)."""
    m = BETA1 * m + (1 - BETA1) * g
    v = BETA2 * v + (1 - BETA2) * g * g
    upd = lr * (m / (1 - BETA1 ** t)) / (torch.sqrt(v / (1 - BETA2 ** t)) + EPS)
    return p - upd, m, v


def step(params: Dict[str, torch.Tensor], w2c, K, target: torch.Tensor, width: int,
         height: int, background: torch.Tensor, lambda_ssim: float, tile_size: int,
         max_tiles: int, tf32: bool = False, loss_rows: int | None = None):
    """One view's loss and the gradients of ``params`` (their dtype is
    ``hi``): (loss, {leaf: gradient})."""
    hi = params["means"].dtype
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    s = R.splats(leaves, w2c, K, width, height, tf32=tf32)
    tiles = R.bin_tiles(binning32(params, w2c, K, width, height), width, height, tile_size,
                        max_tiles)
    s32 = R.to32(s)
    rgb, t_fin, _ = R.composite(s32, tiles, width, height, tf32)
    rgb = rgb.to(hi).requires_grad_(True)
    t_fin = t_fin.to(hi).requires_grad_(True)
    image = R.clip01(rgb + t_fin[..., None] * background.to(hi))
    total = loss(image, target.to(hi), lambda_ssim, tf32, loss_rows)
    g_rgb, g_t = torch.autograd.grad(total, [rgb, t_fin])
    v = R.composite_backward(s32, tiles, width, height, g_rgb, g_t, hi, tf32)
    torch.autograd.backward([s.means2d, s.conics, s.colors, s.opacities],
                            [x.to(hi) for x in v])
    grads = {k: leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
             for k in LEAVES}
    return float(total.detach()), grads


def follow(params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
           nu: Dict[str, torch.Tensor], steps: Dict[str, int], views: Sequence,
           lrs: Sequence[Dict[str, float]], *, width: int, height: int,
           background: torch.Tensor, lambda_ssim: float, tile_size: int, max_tiles: int,
           tf32: bool = False, loss_rows: int | None = None):
    """Train steps from the state (``params``, Adam moments ``mu``, ``nu``
    and each group's step count, alive rows only, in ``hi``) over ``views``
    ([(w2c, K, target)]) with each step's learning rates. Returns each
    step's loss, each leaf's first gradient and the parameters after the
    last step."""
    p = dict(params)
    m, v = dict(mu), dict(nu)
    losses: List[float] = []
    first = None
    for k, ((w2c, K, target), lr) in enumerate(zip(views, lrs)):
        total, grads = step(p, w2c, K, target, width, height, background, lambda_ssim,
                            tile_size, max_tiles, tf32, loss_rows)
        losses.append(total)
        if first is None:
            first = grads
        with torch.no_grad():
            for name in LEAVES:
                p[name], m[name], v[name] = adam(p[name], m[name], v[name], grads[name],
                                                 steps[name] + k + 1, lr[name])
    return losses, first, p
