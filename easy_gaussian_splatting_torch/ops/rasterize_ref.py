"""Oracle renderer: depth-ordered alpha compositing of projected Gaussians;
counterpart of ``easy_gaussian_splatting_tpu/ops/rasterize_ref.py``.

An exact O(N * P) front-to-back compositing ``C = sum_i c_i a_i T_i``,
``T_{i+1} = T_i (1 - a_i)``, with the standard early stop (a Gaussian that
would push transmittance below ``T_EPS`` is skipped and the pixel ends),
then the background blend; and its hand-derived backward, which walks the
list back to front and also returns the absgrad side channel (per-Gaussian
sums of the absolute screen-mean gradients of each pixel, which
densification reads) as the gradient of ``absgrad_dummy``. It is the
numerical oracle for the tiled kernels and the ``renderer: ref`` path."""

from __future__ import annotations

import torch

from .clip import minimum

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
    """Per-(gaussian, pixel) evaluation, all [c, P]: alpha (clamped and
    zeroed where ineligible), the eligibility mask, G = exp(-sigma)
    (unclamped) and the pixel-to-mean deltas dx, dy."""
    dx = m2d[:, 0:1] - px[None, :]
    dy = m2d[:, 1:2] - py[None, :]
    a = conics[:, 0:1]
    b = conics[:, 1:2]
    c = conics[:, 2:3]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    G = torch.exp(-sigma)
    alpha = minimum(opac[:, None] * G, ALPHA_CLAMP)
    elig = (sigma >= 0.0) & (alpha >= ALPHA_THRESH)
    return torch.where(elig, alpha, torch.zeros_like(alpha)), elig, G, dx, dy


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
        alpha, elig, _, _, _ = _alpha_terms(means2d[sl], conics[sl], opacities[sl], px, py)
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


def _backward(means2d, conics, colors, opacities, final_t, last, g_img, g_t, height, width, chunk):
    """The hand-derived VJP of :func:`_forward`, back to front by chunk.
    Returns (v_means2d, v_conics, v_colors, v_opacities, v_abs)."""
    device = means2d.device
    n = means2d.shape[0]
    px, py = _pixel_centers(height, width, device)
    p = px.shape[0]
    g_img_f = g_img.reshape(p, 3)
    t_after = final_t.reshape(p)
    # S carries the suffix term sum_{j>g} (g . c_j) w_j + g_T T_fin; the
    # background is blended by the caller, so only g_T enters here
    s_after = g_t.reshape(p) * t_after
    outs = []
    for k0 in reversed(range(0, n, chunk)):
        sl = slice(k0, min(k0 + chunk, n))
        con_c, opa_c = conics[sl], opacities[sl]
        alpha, elig, G, dx, dy = _alpha_terms(means2d[sl], con_c, opa_c, px, py)
        pos = torch.arange(sl.start, sl.stop, device=device)[:, None]
        composite = elig & (pos <= last[None, :])
        one_minus = torch.where(composite, 1.0 - alpha, torch.ones_like(alpha))
        inv = 1.0 / one_minus
        # T in front of g, back to front: T_after_chunk * prod_{j>=g} inv_j
        rc = torch.flip(torch.cumprod(torch.flip(inv, [0]), dim=0), [0])
        t_g = t_after[None, :] * rc
        w = torch.where(composite, alpha * t_g, torch.zeros_like(alpha))
        dotc = colors[sl] @ g_img_f.T  # [c, P]
        dw = dotc * w
        rs = torch.flip(torch.cumsum(torch.flip(dw, [0]), dim=0), [0]) - dw
        s_g = s_after[None, :] + rs
        v_alpha = torch.where(composite, dotc * t_g - s_g * inv, torch.zeros_like(alpha))
        v_sigma = -G * opa_c[:, None] * v_alpha
        v_opac = torch.sum(G * v_alpha, dim=1)
        v_color = w @ g_img_f
        a, b, c = con_c[:, 0:1], con_c[:, 1:2], con_c[:, 2:3]
        v_conic = torch.stack(
            [
                torch.sum(v_sigma * 0.5 * dx * dx, dim=1),
                torch.sum(v_sigma * dx * dy, dim=1),
                torch.sum(v_sigma * 0.5 * dy * dy, dim=1),
            ],
            dim=-1,
        )
        gx = v_sigma * (a * dx + b * dy)
        gy = v_sigma * (b * dx + c * dy)
        v_m2d = torch.stack([gx.sum(dim=1), gy.sum(dim=1)], dim=-1)
        v_abs = torch.stack([gx.abs().sum(dim=1), gy.abs().sum(dim=1)], dim=-1)
        t_after = t_after * rc[0]
        s_after = s_after + dw.sum(dim=0)
        outs.append((v_m2d, v_conic, v_color, v_opac, v_abs))
    outs.reverse()
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


class _RasterizeSorted(torch.autograd.Function):
    """``rasterize_sorted``'s custom VJP as an autograd Function: the
    gradient of ``absgrad_dummy`` is the absgrad side channel."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, absgrad_dummy, height, width, chunk):
        img, final_t, last = _forward(means2d, conics, colors, opacities, height, width, chunk)
        ctx.save_for_backward(means2d, conics, colors, opacities, final_t, last)
        ctx.dims = (height, width, chunk)
        return img, final_t

    @staticmethod
    def backward(ctx, g_img, g_t):
        means2d, conics, colors, opacities, final_t, last = ctx.saved_tensors
        v_m2d, v_conic, v_color, v_opac, v_abs = _backward(
            means2d, conics, colors, opacities, final_t, last, g_img, g_t, *ctx.dims
        )
        v_abs = v_abs if ctx.needs_input_grad[4] else None
        return v_m2d, v_conic, v_color, v_opac, v_abs, None, None, None


def rasterize_sorted(
    means2d: torch.Tensor,  # [N, 2] depth-sorted screen means (pixels)
    conics: torch.Tensor,  # [N, 3] depth-sorted conics (a, b, c)
    colors: torch.Tensor,  # [N, 3] depth-sorted RGB
    opacities: torch.Tensor,  # [N] depth-sorted; 0 for culled/invalid
    absgrad_dummy: torch.Tensor | None,  # [N, 2] zeros; its gradient is absgrad
    height: int,
    width: int,
    chunk: int = 128,
):
    """Composite depth-sorted 2D Gaussians. Returns (image [H,W,3], final
    transmittance [H,W])."""
    return _RasterizeSorted.apply(
        means2d, conics, colors, opacities, absgrad_dummy, height, width, chunk
    )


def rasterize(
    means2d: torch.Tensor,  # [N, 2]
    conics: torch.Tensor,  # [N, 3]
    colors: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N] (0 for culled)
    depths: torch.Tensor,  # [N]
    background: torch.Tensor,  # [3]
    absgrad_dummy: torch.Tensor | None,  # [N, 2] zeros (None: no absgrad)
    height: int,
    width: int,
    chunk: int = 128,
    radii: torch.Tensor | None = None,  # unified rasterizer signature; the
    # oracle composites every eligible Gaussian so radii are not needed
    y_limit: torch.Tensor | None = None,  # unified signature: the oracle
    # renders every row of the window
):
    """Depth-sort then composite; blends the background (``C += T_final *
    bg``). Returns (image [H,W,3], alpha [H,W])."""
    del radii, y_limit
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(opacities > 0.0, depths, inf), stable=True)
    img, final_t = rasterize_sorted(
        means2d[order], conics[order], colors[order], opacities[order],
        None if absgrad_dummy is None else absgrad_dummy[order],
        height, width, chunk,
    )
    img = img + final_t[..., None] * background[None, None, :]
    return img, 1.0 - final_t
