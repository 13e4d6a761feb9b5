"""Oracle renderer: depth-ordered alpha compositing of projected Gaussians;
counterpart of the forward of ``easy_gaussian_splatting_tpu/ops/rasterize_ref.py``.

An exact O(N * P) front-to-back compositing ``C = sum_i c_i a_i T_i``,
``T_{i+1} = T_i (1 - a_i)``, with the standard early stop (a Gaussian that
would push transmittance below ``T_EPS`` is skipped and the pixel ends),
then the background blend. It is the numerical oracle for the tiled
kernels and the ``renderer: ref`` path. Its hand-derived backward comes
with the training part of the port."""

from __future__ import annotations

import torch

ALPHA_CLAMP = 0.999
ALPHA_THRESH = 1.0 / 255.0
T_EPS = 1e-4


def _pixel_centers(height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flattened pixel centers with the +0.5 convention, row-major."""
    px = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    pyg, pxg = torch.meshgrid(py, px, indexing="ij")  # [H, W]
    return pxg.reshape(-1), pyg.reshape(-1)


def _alpha_terms(m2d, conics, opac, px, py):
    """Per-(gaussian, pixel) alpha [c, P], clamped and zeroed where
    ineligible, and the eligibility mask."""
    dx = m2d[:, 0:1] - px[None, :]
    dy = m2d[:, 1:2] - py[None, :]
    a = conics[:, 0:1]
    b = conics[:, 1:2]
    c = conics[:, 2:3]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opac[:, None] * torch.exp(-sigma), max=ALPHA_CLAMP)
    elig = (sigma >= 0.0) & (alpha >= ALPHA_THRESH)
    return torch.where(elig, alpha, torch.zeros_like(alpha)), elig


def _forward(means2d, conics, colors, opacities, height, width, chunk):
    """Composite depth-sorted Gaussians chunk by chunk. Returns (image
    [H,W,3], final transmittance [H,W], last contributor index [P])."""
    device = means2d.device
    n = means2d.shape[0]
    px, py = _pixel_centers(height, width, device)
    p = px.shape[0]
    t_in = torch.ones(p, dtype=torch.float32, device=device)
    done = torch.zeros(p, dtype=torch.bool, device=device)
    accum = torch.zeros(p, 3, dtype=torch.float32, device=device)
    last = torch.full((p,), -1, dtype=torch.int64, device=device)
    for k0 in range(0, n, chunk):
        sl = slice(k0, min(k0 + chunk, n))
        alpha, elig = _alpha_terms(means2d[sl], conics[sl], opacities[sl], px, py)
        one_minus = 1.0 - alpha  # == 1 where ineligible
        cum_incl = torch.cumprod(one_minus, dim=0)
        cum_excl = torch.cat([torch.ones_like(cum_incl[:1]), cum_incl[:-1]], dim=0)
        t_g = t_in[None, :] * cum_excl  # transmittance before each gaussian
        stop = elig & (t_g * one_minus < T_EPS)
        done_incl = (torch.cummax(stop.to(torch.int32), dim=0).values > 0) | done[None, :]
        composite = elig & ~done_incl
        w = torch.where(composite, alpha * t_g, torch.zeros_like(alpha))
        accum = accum + w.T @ colors[sl]
        om_eff = torch.where(composite, one_minus, torch.ones_like(one_minus))
        t_in = t_in * torch.prod(om_eff, dim=0)
        done = done | stop.any(dim=0)
        pos = torch.arange(sl.start, sl.stop, device=device)[:, None]
        last_c = torch.where(composite, pos, torch.full_like(pos, -1)).amax(dim=0)
        last = torch.maximum(last, last_c)
    return accum.reshape(height, width, 3), t_in.reshape(height, width), last


def rasterize(
    means2d: torch.Tensor,  # [N, 2]
    conics: torch.Tensor,  # [N, 3]
    colors: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N] (0 for culled)
    depths: torch.Tensor,  # [N]
    background: torch.Tensor,  # [3]
    height: int,
    width: int,
    chunk: int = 128,
    radii: torch.Tensor | None = None,  # unified rasterizer signature; the
    # oracle composites every eligible Gaussian so radii are not needed
):
    """Depth-sort then composite; blends the background (``C += T_final *
    bg``). Returns (image [H,W,3], alpha [H,W])."""
    del radii
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(opacities > 0.0, depths, inf), stable=True)
    img, final_t, _ = _forward(
        means2d[order], conics[order], colors[order], opacities[order],
        height, width, chunk,
    )
    img = img + final_t[..., None] * background[None, None, :]
    return img, 1.0 - final_t
