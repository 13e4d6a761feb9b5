"""Plain reference of 3D Gaussian Splatting's forward and its gradient, in
PyTorch tensor operations: the EWA projection, colour from spherical
harmonics, the binning of Gaussians into 32-pixel tiles, depth-ordered
front-to-back compositing per tile and its hand-derived gradient.

It follows Kerbl et al. 2023 (3D Gaussian Splatting) as the port runs it,
written out here from the formulas rather than taken from the port: the
screen blur of 0.3, the 1.3x frustum clamp of the Jacobian, a radius of
three standard deviations, alpha = min(opacity * exp(-sigma), 0.999),
pairs below alpha 1/255 skipped, and a pixel's walk ending before the
Gaussian that would take its transmittance below 1e-4. Two rules decide
which tiles a Gaussian is listed in, and are the port's binning
(``easy_gaussian_splatting_torch/ops/rasterize_tiled.py`` and
``ops/kernels/binkeys.py::tile_sigma_min``, rewritten from commit
cecd31169c04ec6e0b647a102e329261f797bf62): a window of at most
``max_tiles``^2 tiles around its centre tile, and a tile only when the
Gaussian's quadratic form reaches ``min(ln(opacity * 255), 4.5)`` inside it.

Imports nothing of the port. :func:`splats` (projection, SH, activations)
works in any float dtype and under autograd: the reference runs it in
float64. Compositing runs in float32, the configured precision, on those
values rounded to it, over the tile lists that the binning makes from the
screen-space Gaussians as the program rounds them (``program32.py``: the
decisions only, which tiles list which Gaussian in which order).
``tf32=True`` rounds the operands of every matrix product to TF32 (10
mantissa bits): the control, the precision below the configured one.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple, Tuple

import torch

ALPHA_CLAMP = 0.999
ALPHA_THRESH = 1.0 / 255.0
T_EPS = 1e-4
NEAR_PLANE = 0.01
FAR_PLANE = 1e10
EPS2D = 0.3
S_MAX_CAP = 4.5  # the tile test's 3-sigma cap, 3^2 / 2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
# (pixel, listed Gaussian) pairs a batch of tiles holds
FORWARD_BATCH_PAIRS = 1 << 25
BACKWARD_BATCH_PAIRS = 1 << 24


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    """max(x, v) with the gradient split half and half at a tie."""
    return torch.maximum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def _min(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def clip01(x: torch.Tensor) -> torch.Tensor:
    return _min(_max(x, 0.0), 1.0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even
    (the gradient passes through the rounding unchanged)."""
    xd = x.detach().contiguous()
    i = xd.view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (r - xd) if x.requires_grad else r


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return torch.matmul(tf32_round(a), tf32_round(b))
    return torch.matmul(a, b)


class Splats(NamedTuple):
    """Screen-space Gaussians, one row per Gaussian."""

    means2d: torch.Tensor  # [N, 2] pixels
    conics: torch.Tensor  # [N, 3] (a, b, c) of the inverse 2D covariance
    colors: torch.Tensor  # [N, 3]
    opacities: torch.Tensor  # [N]
    depths: torch.Tensor  # [N] camera z
    radii: torch.Tensor  # [N] pixels, 0 where culled


def splats(params: Dict[str, torch.Tensor], w2c: torch.Tensor, K: torch.Tensor,
           width: int, height: int, sh_degree: int = 3, tf32: bool = False) -> Splats:
    """Activations, EWA projection and SH colour of the Gaussians
    ``params`` (``means [N,3]``, ``log_scales [N,3]``, ``quats [N,4]`` wxyz,
    ``sh_0 [N,1,3]``, ``sh_rest [N,15,3]``, ``logit_opacities [N]``), in
    their dtype; ``w2c`` and ``K`` are cast to it. A culled Gaussian has
    radius 0."""
    means = params["means"]
    dt = means.dtype
    w2c, K = w2c.to(dt), K.to(dt)
    scales = torch.exp(params["log_scales"])
    opac = torch.sigmoid(params["logit_opacities"])
    R, t = w2c[:3, :3], w2c[:3, 3]
    p = matmul(means, R.T, tf32) + t
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zsafe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)

    q = params["quats"] / _max(torch.linalg.norm(params["quats"], dim=-1, keepdim=True), 1e-12)
    w, qx, qy, qz = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy),
        2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx),
        2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy),
    ], -1).reshape(-1, 3, 3)
    m = matmul(R[None], rot, tf32) * scales[:, None, :]  # camera-axes R M S
    cov = matmul(m, m.transpose(1, 2), tf32)  # [N, 3, 3]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    lim_x, lim_y = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    tx = torch.minimum(torch.maximum(x / zsafe, -lim_x), lim_x) * z
    ty = torch.minimum(torch.maximum(y / zsafe, -lim_y), lim_y) * z
    rz = 1.0 / zsafe
    zero = torch.zeros_like(z)
    J = torch.stack([fx * rz, zero, -fx * tx * rz * rz,
                     zero, fy * rz, -fy * ty * rz * rz], -1).reshape(-1, 2, 3)
    c2 = matmul(matmul(J, cov, tf32), J.transpose(1, 2), tf32)
    c00, c01, c11 = c2[:, 0, 0] + EPS2D, c2[:, 0, 1], c2[:, 1, 1] + EPS2D
    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conics = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe], -1)
    b = 0.5 * (c00 + c11)
    radius = torch.ceil(3.0 * torch.sqrt(b + torch.sqrt(_max(b * b - det, 0.01)))).detach()
    mean2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], -1)
    md = mean2d.detach()
    valid = ((z > NEAR_PLANE) & (z < FAR_PLANE) & (det > 0)
             & (md[:, 0] + radius > 0) & (md[:, 0] - radius < width)
             & (md[:, 1] + radius > 0) & (md[:, 1] - radius < height) & (radius > 0))
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    cam = -(R.T @ t)
    dirs = means - cam
    dirs = dirs / _max(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    colors = _max(sh_color(params["sh_0"][:, 0], params["sh_rest"], dirs, sh_degree) + 0.5, 0.0)
    return Splats(mean2d, conics, colors, opac, z, radius)


def sh_color(sh0: torch.Tensor, rest: torch.Tensor, d: torch.Tensor, degree: int):
    """Real spherical harmonics up to ``degree`` (<= 3) along unit ``d``."""
    out = SH_C0 * sh0
    if degree < 1:
        return out
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = out - SH_C1 * y * rest[:, 0] + SH_C1 * z * rest[:, 1] - SH_C1 * x * rest[:, 2]
    if degree < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis2 = (xy, yz, 2 * zz - xx - yy, xz, xx - yy)
    for k, (c, v) in enumerate(zip(SH_C2, basis2)):
        out = out + c * v * rest[:, 3 + k]
    if degree < 3:
        return out
    basis3 = (y * (3 * xx - yy), xy * z, y * (4 * zz - xx - yy), z * (2 * zz - 3 * xx - 3 * yy),
              x * (4 * zz - xx - yy), z * (xx - yy), x * (xx - 3 * yy))
    for k, (c, v) in enumerate(zip(SH_C3, basis3)):
        out = out + c * v * rest[:, 8 + k]
    return out


# ------------------------------------------------------------------ binning
class Tiles(NamedTuple):
    """Each tile's depth-ordered list of Gaussians (CSR)."""

    offsets: torch.Tensor  # [T + 1] int64
    gauss: torch.Tensor  # [D] int64 Gaussian row
    tiles_x: int
    tiles_y: int
    tile_size: int


def tile_sigma_min(x0, y0, ts: int, a, b, c):
    """Least of the quadratic form a/2 dx^2 + c/2 dy^2 + b dx dy over each
    rectangle [x0, x0 + ts] x [y0, y0 + ts] (corners relative to the mean):
    0 when the mean lies inside, else the least of the four clamped edge
    minima."""
    x1, y1 = x0 + ts, y0 + ts
    a_safe, c_safe = torch.clamp(a, min=1e-12), torch.clamp(c, min=1e-12)

    def sig(dx, dy):
        return 0.5 * a * dx * dx + 0.5 * c * dy * dy + b * dx * dy

    def edge_x(xe):
        return sig(xe, torch.clamp(-b * xe / c_safe, min=y0, max=y1))

    def edge_y(ye):
        return sig(torch.clamp(-b * ye / a_safe, min=x0, max=x1), ye)

    s_edge = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                           torch.minimum(edge_y(y0), edge_y(y1)))
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    return torch.where(inside, torch.zeros_like(s_edge), s_edge)


def bin_tiles(s: Splats, width: int, height: int, tile_size: int = 32,
              max_tiles: int = 4) -> Tiles:
    """The tiles each Gaussian is listed in, and each tile's list in depth
    order (float32 splats; ``colors`` is not read)."""
    mx, my = s.means2d[:, 0], s.means2d[:, 1]
    a, b, c = s.conics.unbind(-1)
    opac, dev = s.opacities, s.means2d.device
    n, ts, m = mx.shape[0], tile_size, max_tiles * max_tiles
    det_inv = torch.clamp(a * c - b * b, min=1e-12)
    s_max = torch.clamp(torch.log(torch.clamp(opac, min=1e-12) / ALPHA_THRESH), 0.0, S_MAX_CAP)
    rx = torch.sqrt(2.0 * s_max * torch.clamp(c / det_inv, min=0.0))
    ry = torch.sqrt(2.0 * s_max * torch.clamp(a / det_inv, min=0.0))
    live = (s.radii > 0) & (opac > ALPHA_THRESH)
    rx = torch.where(live, torch.minimum(rx, s.radii), torch.zeros_like(rx))
    ry = torch.where(live, torch.minimum(ry, s.radii), torch.zeros_like(ry))
    valid = (rx > 0) & (ry > 0) & ((my - ry) < float(height))
    order = torch.argsort(torch.where(valid, s.depths, torch.full_like(s.depths, math.inf)),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    tx_n, ty_n = -(-width // ts), -(-height // ts)

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int32)

    tx0, tx1 = tile_of(mx - rx, tx_n - 1), tile_of(mx + rx, tx_n - 1)
    ty0, ty1 = tile_of(my - ry, ty_n - 1), tile_of(my + ry, ty_n - 1)
    cx = torch.clamp(torch.floor(mx / ts).to(torch.int32), tx0, tx1)
    cy = torch.clamp(torch.floor(my / ts).to(torch.int32), ty0, ty1)
    w = torch.clamp(tx1 - tx0 + 1, max=m)
    h = torch.clamp(ty1 - ty0 + 1, max=m)
    over = w * h > m
    shrink_w = over & (w >= h)
    w = torch.where(shrink_w, torch.clamp(m // h, min=1), w)
    h = torch.where(over & ~shrink_w, torch.clamp(m // w, min=1), h)
    tx0 = torch.clamp(cx - (w - 1) // 2, tx0, tx1 - w + 1)
    ty0 = torch.clamp(cy - (h - 1) // 2, ty0, ty1 - h + 1)
    count = torch.where(valid, w * h, torch.zeros_like(w))
    keep = count > 0
    rows = torch.nonzero(keep).squeeze(1)
    mx, my, a, b, c, s_max = (v[rows] for v in (mx, my, a, b, c, s_max))
    tx0, ty0, w, count, rank = (v[rows] for v in (tx0, ty0, w, count, rank))
    keys, gids = [], []
    for j in range(m):
        jy = torch.div(j, torch.clamp(w, min=1), rounding_mode="floor")
        jx = j - jy * w
        x0 = ((tx0 + jx) * ts).to(torch.float32) - mx
        y0 = ((ty0 + jy) * ts).to(torch.float32) - my
        hit = (j < count) & (tile_sigma_min(x0, y0, ts, a, b, c) <= s_max)
        tile = ((ty0 + jy) * tx_n + tx0 + jx).to(torch.int64)
        keys.append((tile * n + rank)[hit])
        gids.append(rows[hit])
    keys, gids = torch.cat(keys), torch.cat(gids)
    keys, perm = torch.sort(keys)
    tiles = torch.div(keys, n, rounding_mode="floor")
    counts = torch.bincount(tiles, minlength=tx_n * ty_n)
    offsets = torch.zeros(tx_n * ty_n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return Tiles(offsets, gids[perm], tx_n, ty_n, ts)


# --------------------------------------------------------------- compositing
def _batches(tiles: Tiles, max_pairs: int) -> Iterator[Tuple[torch.Tensor, int]]:
    """Tiles in batches, longest lists first: (tile ids [B], longest list),
    at most ``max_pairs`` (pixel, padded list entry) pairs a batch."""
    lengths = tiles.offsets[1:] - tiles.offsets[:-1]
    order = torch.argsort(lengths, descending=True)
    lens = lengths[order].tolist()
    p = tiles.tile_size ** 2
    i = 0
    while i < len(lens) and lens[i] > 0:
        longest = lens[i]
        b = max(1, max_pairs // (p * longest))
        yield order[i:i + b], longest
        i += b


class _Batch(NamedTuple):
    idx: torch.Tensor  # [B, L] Gaussian rows (0 where padding)
    in_range: torch.Tensor  # [B, L]
    real: torch.Tensor  # [B, P] pixel inside the image
    pix: torch.Tensor  # [B, P] flat pixel index (0 where outside)
    alpha: torch.Tensor  # [B, P, L]
    g: torch.Tensor  # [B, P, L] exp(-sigma)
    dx: torch.Tensor
    dy: torch.Tensor
    comp: torch.Tensor  # composited
    stop: torch.Tensor  # the pair that ends the pixel's walk
    om: torch.Tensor  # 1 - alpha where composited, else 1
    excl: torch.Tensor  # T in front of each pair


def _batch(s: Splats, tiles: Tiles, ids: torch.Tensor, longest: int, width: int,
           height: int) -> _Batch:
    dev = s.means2d.device
    ts = tiles.tile_size
    starts = tiles.offsets[ids]
    lane = torch.arange(longest, device=dev)
    in_range = lane[None, :] < (tiles.offsets[ids + 1] - starts)[:, None]
    idx = tiles.gauss[torch.where(in_range, starts[:, None] + lane[None, :],
                                  torch.zeros_like(starts)[:, None])]
    k = torch.arange(ts * ts, device=dev)
    px = (ids % tiles.tiles_x)[:, None] * ts + k[None, :] % ts
    py = torch.div(ids, tiles.tiles_x, rounding_mode="floor")[:, None] * ts + k[None, :] // ts
    real = (px < width) & (py < height)
    pix = torch.where(real, py * width + px, torch.zeros_like(px))
    dx = s.means2d[idx, 0][:, None, :] - (px.to(torch.float32) + 0.5)[:, :, None]
    dy = s.means2d[idx, 1][:, None, :] - (py.to(torch.float32) + 0.5)[:, :, None]
    con = s.conics[idx]
    sigma = (0.5 * (con[..., 0][:, None, :] * dx * dx + con[..., 2][:, None, :] * dy * dy)
             + con[..., 1][:, None, :] * dx * dy)
    g = torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(s.opacities[idx][:, None, :] * g, max=ALPHA_CLAMP)
    elig = (alpha >= ALPHA_THRESH) & in_range[:, None, :]
    om = torch.where(elig, 1.0 - alpha, torch.ones_like(alpha))
    incl = torch.cumprod(om, dim=-1)
    excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    stop = elig & (incl < T_EPS)
    stopped = torch.cummax(stop.to(torch.int8), dim=-1).values > 0
    comp = elig & ~stopped
    om = torch.where(comp, om, torch.ones_like(om))
    return _Batch(idx, in_range, real, pix, alpha, g, dx, dy, comp, stop, om, excl)


def composite(s: Splats, tiles: Tiles, width: int, height: int, tf32: bool = False,
              counts: bool = False):
    """Front-to-back compositing of each tile's list: (rgb [H, W, 3] before
    the background, final transmittance [H, W], work counts or None). The
    counts, over the image's own pixels: ``composited`` pairs, ``walk_rows``
    (per tile, the list entries up to its last pixel's stop) and
    ``live_rows`` (list entries)."""
    dev = s.means2d.device
    rgb = torch.zeros((height * width, 3), dtype=torch.float32, device=dev)
    t_fin = torch.ones(height * width, dtype=torch.float32, device=dev)
    n = dict(composited=0, walk_rows=0, live_rows=int(tiles.offsets[-1]),
             tiles=tiles.tiles_x * tiles.tiles_y, tile_pixels=tiles.tile_size ** 2,
             pixels=width * height)
    for ids, longest in _batches(tiles, FORWARD_BATCH_PAIRS):
        bt = _batch(s, tiles, ids, longest, width, height)
        w = torch.where(bt.comp, bt.alpha * bt.excl, torch.zeros_like(bt.alpha))
        out = matmul(w, s.colors[bt.idx], tf32)  # [B, P, 3]
        tf = bt.om.prod(dim=-1)
        rgb[bt.pix[bt.real]] = out[bt.real]
        t_fin[bt.pix[bt.real]] = tf[bt.real]
        if counts:
            # a pixel's walk: up to its stop, or the whole list
            ends = torch.where(bt.stop.any(-1), torch.argmax(bt.stop.to(torch.int8), -1) + 1,
                               bt.in_range.sum(-1, keepdim=True).expand_as(bt.stop[..., 0]))
            n["walk_rows"] += int(torch.where(bt.real, ends, 0).amax(-1).sum())
            n["composited"] += int((bt.comp & bt.real[..., None]).sum())
        del bt, w, out
    return rgb.reshape(height, width, 3), t_fin.reshape(height, width), (n if counts else None)


def composite_backward(s: Splats, tiles: Tiles, width: int, height: int,
                       g_rgb: torch.Tensor, g_t: torch.Tensor, acc_dtype=torch.float64,
                       tf32: bool = False):
    """The gradient of :func:`composite` (float32 math, per-Gaussian sums in
    ``acc_dtype``): given dL/d rgb [H, W, 3] and dL/dT [H, W], returns
    dL/d (means2d [N,2], conics [N,3], colors [N,3], opacities [N])."""
    n = s.means2d.shape[0]
    dev = s.means2d.device
    v_m = torch.zeros((n, 2), dtype=acc_dtype, device=dev)
    v_con = torch.zeros((n, 3), dtype=acc_dtype, device=dev)
    v_col = torch.zeros((n, 3), dtype=acc_dtype, device=dev)
    v_op = torch.zeros(n, dtype=acc_dtype, device=dev)
    g_rgb = g_rgb.reshape(-1, 3).to(torch.float32)
    g_t = g_t.reshape(-1).to(torch.float32)
    for ids, longest in _batches(tiles, BACKWARD_BATCH_PAIRS):
        bt = _batch(s, tiles, ids, longest, width, height)
        gi = torch.where(bt.real[..., None], g_rgb[bt.pix], torch.zeros(()).to(g_rgb))
        gt = torch.where(bt.real, g_t[bt.pix], torch.zeros(()).to(g_t))
        col = s.colors[bt.idx]  # [B, L, 3]
        w = torch.where(bt.comp, bt.alpha * bt.excl, torch.zeros_like(bt.alpha))
        dotc = matmul(gi, col.transpose(1, 2), tf32)  # [B, P, L]
        dw = dotc * w
        suffix = torch.flip(torch.cumsum(torch.flip(dw, [-1]), dim=-1), [-1]) - dw
        t_fin = bt.om.prod(dim=-1, keepdim=True)
        s_g = suffix + gt[..., None] * t_fin
        v_alpha = torch.where(bt.comp, dotc * bt.excl - s_g / bt.om, torch.zeros_like(dw))
        op = s.opacities[bt.idx][:, None, :]
        v_sigma = -op * bt.g * v_alpha
        con = s.conics[bt.idx]
        a, b, c = (con[..., k][:, None, :] for k in range(3))
        dx, dy = bt.dx, bt.dy
        rows = bt.idx[bt.in_range]
        sel = bt.in_range

        def add(dst, val):
            dst.index_add_(0, rows, val[sel].to(acc_dtype))

        add(v_m, torch.stack([(v_sigma * (a * dx + b * dy)).sum(1),
                              (v_sigma * (b * dx + c * dy)).sum(1)], -1))
        add(v_con, torch.stack([(0.5 * v_sigma * dx * dx).sum(1), (v_sigma * dx * dy).sum(1),
                                (0.5 * v_sigma * dy * dy).sum(1)], -1))
        add(v_col, matmul(w.transpose(1, 2), gi, tf32))
        add(v_op, (bt.g * v_alpha).sum(1))
        del bt, w, dotc, dw, suffix, s_g, v_alpha, v_sigma
    return v_m, v_con, v_col, v_op


def to32(s: Splats) -> Splats:
    """``s`` rounded to float32 and detached, for compositing."""
    return Splats(*(x.detach().to(torch.float32) for x in s))


def render(params: Dict[str, torch.Tensor], w2c, K, width: int, height: int,
           background: torch.Tensor, tile_size: int = 32, max_tiles: int = 4,
           tf32: bool = False, counts: bool = False):
    """The served image [H, W, 3] in [0, 1] (float32) and, with ``counts``,
    the compositing's work counts: :func:`splats` in the dtype of
    ``params``, composited in float32 over the tile lists binned from
    ``program32.binning32``."""
    from .program32 import binning32

    with torch.no_grad():
        tiles = bin_tiles(binning32(params, w2c, K, width, height), width, height, tile_size,
                          max_tiles)
        s = to32(splats(params, w2c, K, width, height, tf32=tf32))
        rgb, t_fin, n = composite(s, tiles, width, height, tf32, counts)
        bg = background.to(torch.float32)
        img = torch.clamp(rgb + t_fin[..., None] * bg, 0.0, 1.0)
    return img, n
