"""Tiled forward compositing: the CUDA kernel ``csrc/tile_forward.cu`` and
its plain PyTorch version.

Counterpart of ``easy_gaussian_splatting_tpu/ops/pallas/tile_raster.py::
tiled_forward``. Features are row-major ``[I, 16]`` (one row per
intersection, columns as in ``rasterize_tiled.pack_features``) rather
than the TPU's feature-major ``[16, I_pad]``; the math and the decoded
outputs are the same: rgb [T, P, 3], final transmittance [T, P] and the
global index of each pixel's last composited intersection [T, P] (-1 if
none).

Counterpart of ``tiled_backward`` too (kernel ``csrc/tile_backward.cu``):
per-intersection gradient rows [I, 16] f32, columns 0-10 in the order of
the JAX kernel's decoded rows (``grad_rows_to_f32``): v_mx, v_my, v_a,
v_b, v_c, v_opac, v_rgb x3, v_absx, v_absy; columns 11-15 are zero. The
JAX kernel's bf16 hi/lo lane split exists for the TPU only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, T_EPS
from . import _build

NUM_FEATURES = 16
# slack on the tile-local polynomial's sigma >= 0 test: its expansion
# carries ~1e-4 cancellation error near a Gaussian's center
SIGMA_EPS = 1e-3
ROW_OPACITY = 6  # -log(opacity), multiplied by basis column 6 (= 1)
ROW_MX = 7
ROW_COLOR = 8
ROW_CONIC = 11
ROW_MY = 14
NUM_GRAD_COLS = 16  # gradient row width (11 live columns, 16-byte aligned)
NUM_LIVE_GRADS = 11
MAX_TILE_PIXELS = 1024  # two pixels per thread, 512 threads in a block
WARP_PIXELS = 64  # pixels of one warp of the tile kernels, two per lane
# s2 beyond it: exp(-s2) < 1/255 for any rounding of exp, so not eligible;
# the tile kernels' per-warp cull skips the rows whose s2 is beyond it at
# every pixel of the warp, with these allowances (csrc/tile_cull.cuh; the
# wrappers pass them at each call)
S2_REACH = 5.6
CULL_COEF_TOL = 1e-5
CULL_S2_SLACK = 3e-5
CULL_EXT_SLACK = 1e-2
CULL_DET_MIN = 1e-4
# (pixel, intersection) pairs per batch of tiles in the plain version
PLAIN_BATCH_PAIRS = 1 << 26
# the backward's plain version keeps ~20 [B, P, L] temporaries
PLAIN_BWD_BATCH_PAIRS = 1 << 24

# kernel launches made by `tiled_forward` and `tiled_backward` (the plain
# versions never count)
launches = 0
backward_launches = 0


def _sigma2(f: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """s2 [B, P, L] = f[..., 0:7] . basis[:, 0:7] for features [B, L, 16],
    summed term by term in the kernels' order: the kernels round each
    product and sum on its own (``csrc/tile_eligibility.cuh``), so the
    plain versions and the kernels round it identically, and the backward
    replays the forward's eligibility test exactly."""
    s2 = f[..., 0][:, None, :] * basis[:, 0][None, :, None]
    for k in range(1, 7):
        s2 = s2 + f[..., k][:, None, :] * basis[:, k][None, :, None]
    return s2


def _tile_batches(counts_h, p: int, max_pairs: int):
    """Consecutive tile ranges [t0, t1) with the longest list in each, at
    most ``max_pairs`` (pixel, padded intersection) pairs per range."""
    num_tiles = len(counts_h)
    t0 = 0
    while t0 < num_tiles:
        t1, longest = t0 + 1, counts_h[t0]
        while t1 < num_tiles:
            wider = max(longest, counts_h[t1])
            if (t1 - t0 + 1) * p * wider > max_pairs:
                break
            longest, t1 = wider, t1 + 1
        yield t0, t1, longest
        t0 = t1


def warp_block_side(p: int) -> int:
    """The tile's side when its ``p`` pixels are a square whose side is a
    multiple of 8: the tile kernels then give each warp an 8x8 block of
    pixels. Else 0: each warp takes 64 consecutive pixels."""
    side = math.isqrt(p)
    return side if side * side == p and side % 8 == 0 else 0


def warp_pixels(p: int) -> torch.Tensor:
    """[W, 64] i64: the pixels of each of the tile kernels' W warps, in
    their layout (slot ``32 k + lane`` is pixel ``k`` of lane ``lane``); ``p``
    where a warp has no pixel."""
    warps = -(-p // WARP_PIXELS)
    w = torch.arange(warps)[:, None]
    slot = torch.arange(WARP_PIXELS)[None, :]
    lane, k = slot % 32, slot // 32
    side = warp_block_side(p)
    if side:
        blocks_x = side // 8
        x = (w % blocks_x) * 8 + lane % 8
        y = (w // blocks_x) * 8 + lane // 8 + 4 * k
        return y * side + x
    idx = w * WARP_PIXELS + slot
    return torch.where(idx < p, idx, torch.full_like(idx, p))


def _cull_constants():
    """The cull's constants, read at each call, in the order of the kernels'
    ``struct Cull`` (``csrc/tile_cull.cuh``)."""
    return (ctypes.c_float * 6)(
        S2_REACH, CULL_COEF_TOL, CULL_S2_SLACK, 1.0 + CULL_EXT_SLACK, CULL_EXT_SLACK, CULL_DET_MIN
    )


def warp_reach_plain(rows: torch.Tensor, rect, bound=None) -> torch.Tensor:
    """[R] bool: the tile kernels' per-warp cull (``reach_box`` and ``misses``
    in ``csrc/tile_cull.cuh``) on feature rows [R, 16] for the pixel centres'
    bounding box ``rect = (x0, x1, y0, y1)``: False where no pixel of the box
    can find the row eligible (every s2 there beyond ``S2_REACH``), True
    where it may, or where the row fails a premise of the bound. ``bound =
    (X, Y)``, the largest |px| and |py| the rounding allowance assumes, is
    the box's own unless given: the forward kernel computes one box of each
    row for all of a tile's warps, with the tile's."""
    f = rows.to(torch.float32)
    a, b, c = f[:, ROW_CONIC], f[:, ROW_CONIC + 1], f[:, ROW_CONIC + 2]
    mx, my, nlo = f[:, ROW_MX], f[:, ROW_MY], f[:, ROW_OPACITY]
    x0, x1, y0, y1 = (float(v) for v in rect)
    if bound is None:
        bound = (max(abs(x0), abs(x1)), max(abs(y0), abs(y1)))
    big_x, big_y = (float(v) for v in bound)
    amx, bmy, cmy, bmx = a * mx, b * my, c * my, b * mx
    fq = 0.5 * amx * mx + 0.5 * cmy * my + bmx * my
    fm = 0.5 * (amx * mx).abs() + 0.5 * (cmy * my).abs() + (bmx * my).abs()
    form = (
        (f[:, 0] == 0.5 * a) & (f[:, 1] == 0.5 * c) & (f[:, 2] == b)
        & ((f[:, 3] + (amx + bmy)).abs() <= CULL_COEF_TOL * (amx.abs() + bmy.abs()))
        & ((f[:, 4] + (cmy + bmx)).abs() <= CULL_COEF_TOL * (cmy.abs() + bmx.abs()))
        & ((f[:, 5] - fq).abs() <= CULL_COEF_TOL * fm)
    )
    det = a * c - b * b
    usable = form & (a > 0) & (c > 0) & (det > CULL_DET_MIN * a * c)
    ux, uy = big_x + mx.abs(), big_y + my.abs()
    mag = 0.5 * a * ux * ux + 0.5 * c * uy * uy + b.abs() * ux * uy + nlo.abs()
    reach = S2_REACH + CULL_S2_SLACK * mag - nlo
    ex = torch.sqrt(2.0 * reach * c / det) * (1.0 + CULL_EXT_SLACK) + CULL_EXT_SLACK
    ey = torch.sqrt(2.0 * reach * a / det) * (1.0 + CULL_EXT_SLACK) + CULL_EXT_SLACK
    outside = (torch.maximum(x0 - mx, mx - x1) > ex) | (torch.maximum(y0 - my, my - y1) > ey)
    return ~(usable & ((reach <= 0) | outside))


def tiled_forward_plain(
    feats: torch.Tensor,  # [I, 16] f32
    tile_offsets: torch.Tensor,  # [T + 1] i32
    basis: torch.Tensor,  # [P, 8] f32
):
    """The kernel's function with PyTorch ops: tiles are processed in
    batches, each tile's list padded to the batch's longest, bounded to
    about ``PLAIN_BATCH_PAIRS`` (pixel, intersection) pairs per batch. The
    stop rule uses an exclusive cumulative product of (1 - alpha) over eligible
    intersections, as the JAX kernel does; it equals the sequential walk
    up to rounding."""
    device = feats.device
    num_tiles = tile_offsets.shape[0] - 1
    p = basis.shape[0]
    rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=device)
    t_fin = torch.ones((num_tiles, p), dtype=torch.float32, device=device)
    last = torch.full((num_tiles, p), -1, dtype=torch.int32, device=device)
    offs = tile_offsets.to(torch.int64)
    counts_h = (offs[1:] - offs[:-1]).tolist()
    for t0, t1, longest in _tile_batches(counts_h, p, PLAIN_BATCH_PAIRS):
        if longest > 0:
            lane = torch.arange(longest, device=device)
            starts = offs[t0:t1, None]
            in_range = lane[None, :] < (offs[t0 + 1 : t1 + 1, None] - starts)
            idx = torch.where(in_range, starts + lane[None, :], torch.zeros_like(starts))
            f = feats[idx]  # [B, L, 16]
            s2 = _sigma2(f, basis)  # [B, P, L]
            nlo = f[..., ROW_OPACITY][:, None, :]
            alpha = torch.clamp(torch.exp(-torch.maximum(s2, nlo)), max=ALPHA_CLAMP)
            elig = (s2 >= nlo - SIGMA_EPS) & (alpha >= ALPHA_THRESH) & in_range[:, None, :]
            om = torch.where(elig, 1.0 - alpha, torch.ones_like(alpha))
            incl = torch.cumprod(om, dim=-1)
            excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
            stop = elig & (excl * om < T_EPS)
            stopped = torch.cummax(stop.to(torch.int32), dim=-1).values > 0
            comp = elig & ~stopped
            w = torch.where(comp, alpha * excl, torch.zeros_like(alpha))
            rgb[t0:t1] = torch.matmul(w, f[..., ROW_COLOR : ROW_COLOR + 3])
            t_fin[t0:t1] = torch.where(comp, om, torch.ones_like(om)).prod(dim=-1)
            pos = torch.where(comp, lane, torch.full_like(lane, -1)).amax(dim=-1)
            last[t0:t1] = torch.where(pos >= 0, pos + starts, pos).to(torch.int32)
    return rgb, t_fin, last


def tiled_forward(
    feats: torch.Tensor,  # [I, 16] f32
    tile_offsets: torch.Tensor,  # [T + 1] i32, non-decreasing, <= I
    basis: torch.Tensor,  # [P, 8] f32 tile-local pixel basis
):
    """Per-tile front-to-back compositing; returns (rgb [T,P,3], final_T
    [T,P], last [T,P]). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if feats.device.type == "cpu":
        return tiled_forward_plain(feats, tile_offsets, basis)
    dev = feats.device
    if dev.type != "cuda" or tile_offsets.device != dev or basis.device != dev:
        raise ValueError("tiled_forward: all inputs must be on one CUDA device")
    if feats.dtype != torch.float32 or basis.dtype != torch.float32:
        raise ValueError("tiled_forward: feats and basis must be f32")
    if tile_offsets.dtype != torch.int32:
        raise ValueError("tiled_forward: tile_offsets must be i32")
    if feats.dim() != 2 or feats.shape[1] != NUM_FEATURES:
        raise ValueError(f"tiled_forward: feats must be [I, 16], got {tuple(feats.shape)}")
    p = basis.shape[0]
    if basis.shape != (p, 8) or not 0 < p <= MAX_TILE_PIXELS:
        raise ValueError(
            f"tiled_forward: basis must be [P, 8] with P <= {MAX_TILE_PIXELS} "
            f"(tile_size <= 32), got {tuple(basis.shape)}"
        )
    if not (feats.is_contiguous() and tile_offsets.is_contiguous() and basis.is_contiguous()):
        raise ValueError("tiled_forward: inputs must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("tiled_forward: feats must be 16-byte aligned")
    num_tiles = tile_offsets.shape[0] - 1
    rgb = torch.empty((num_tiles, p, 3), dtype=torch.float32, device=dev)
    t_fin = torch.empty((num_tiles, p), dtype=torch.float32, device=dev)
    last = torch.empty((num_tiles, p), dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return rgb, t_fin, last
    lib = _build.load("tile_forward")
    fn = lib.egs_tile_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_void_p]
    )
    err = fn(
        feats.data_ptr(), tile_offsets.data_ptr(), basis.data_ptr(),
        num_tiles, p, warp_block_side(p), _cull_constants(), rgb.data_ptr(),
        t_fin.data_ptr(), last.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tiled_forward kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return rgb, t_fin, last


def tiled_backward_plain(
    feats: torch.Tensor,  # [I, 16] f32
    tile_offsets: torch.Tensor,  # [T + 1] i32
    basis: torch.Tensor,  # [P, 8] f32
    g_img: torch.Tensor,  # [T, P, 3] f32
    g_t: torch.Tensor,  # [T, P] f32
    t_fin: torch.Tensor,  # [T, P] f32
    last: torch.Tensor,  # [T, P] i32
):
    """The kernel's function with PyTorch ops, tiles batched as in the
    forward's plain version. Transmittance in front of each composited
    intersection is the final T divided by the suffix product of (1 -
    alpha); the suffix term S is a reverse exclusive cumulative sum. Both
    equal the kernel's back-to-front walk up to rounding."""
    device = feats.device
    p = basis.shape[0]
    out = torch.zeros((feats.shape[0], NUM_GRAD_COLS), dtype=torch.float32, device=device)
    offs = tile_offsets.to(torch.int64)
    counts_h = (offs[1:] - offs[:-1]).tolist()
    px = basis[:, 3][None, :, None]
    py = basis[:, 4][None, :, None]
    for t0, t1, longest in _tile_batches(counts_h, p, PLAIN_BWD_BATCH_PAIRS):
        if longest == 0:
            continue
        lane = torch.arange(longest, device=device)
        starts = offs[t0:t1, None]
        in_range = lane[None, :] < (offs[t0 + 1 : t1 + 1, None] - starts)
        gpos = starts + lane[None, :]  # [B, L]
        idx = torch.where(in_range, gpos, torch.zeros_like(starts))
        f = feats[idx]  # [B, L, 16]
        s2 = _sigma2(f, basis)  # [B, P, L]
        nlo = f[..., ROW_OPACITY][:, None, :]
        alpha_raw = torch.exp(-torch.maximum(s2, nlo))
        alpha = torch.clamp(alpha_raw, max=ALPHA_CLAMP)
        comp = (
            (s2 >= nlo - SIGMA_EPS) & (alpha >= ALPHA_THRESH) & in_range[:, None, :]
            & (gpos[:, None, :] <= last[t0:t1, :, None].to(torch.int64))
        )
        om = torch.where(comp, 1.0 - alpha, torch.ones_like(alpha))
        suffix_om = torch.flip(torch.cumprod(torch.flip(om, [-1]), dim=-1), [-1])
        t_g = t_fin[t0:t1, :, None] / suffix_om
        w = torch.where(comp, alpha * t_g, torch.zeros_like(alpha))
        gi = g_img[t0:t1]  # [B, P, 3]
        col = f[..., ROW_COLOR : ROW_COLOR + 3]  # [B, L, 3]
        dotc = (
            gi[..., 0:1] * col[..., 0][:, None, :]
            + gi[..., 1:2] * col[..., 1][:, None, :]
            + gi[..., 2:3] * col[..., 2][:, None, :]
        )
        dw = dotc * w
        s_after = torch.flip(torch.cumsum(torch.flip(dw, [-1]), dim=-1), [-1]) - dw
        s_g = (g_t[t0:t1] * t_fin[t0:t1])[..., None] + s_after
        v_alpha = torch.where(comp, dotc * t_g - s_g / om, torch.zeros_like(alpha))
        nvs = alpha_raw * v_alpha  # -v_sigma
        v_sigma = -nvs
        dx = f[..., ROW_MX][:, None, :] - px
        dy = f[..., ROW_MY][:, None, :] - py
        a = f[..., ROW_CONIC][:, None, :]
        b = f[..., ROW_CONIC + 1][:, None, :]
        c = f[..., ROW_CONIC + 2][:, None, :]
        gx = v_sigma * (a * dx + b * dy)
        gy = v_sigma * (b * dx + c * dy)
        vals = torch.stack(
            [
                gx.sum(1),
                gy.sum(1),
                (0.5 * v_sigma * dx * dx).sum(1),
                (v_sigma * dx * dy).sum(1),
                (0.5 * v_sigma * dy * dy).sum(1),
                nvs.sum(1) * torch.exp(f[..., ROW_OPACITY]),
                (w * gi[..., 0:1]).sum(1),
                (w * gi[..., 1:2]).sum(1),
                (w * gi[..., 2:3]).sum(1),
                gx.abs().sum(1),
                gy.abs().sum(1),
            ],
            dim=-1,
        )  # [B, L, 11]
        out[gpos[in_range], :NUM_LIVE_GRADS] = vals[in_range]
    return out


def tiled_backward(
    feats: torch.Tensor,  # [I, 16] f32
    tile_offsets: torch.Tensor,  # [T + 1] i32
    basis: torch.Tensor,  # [P, 8] f32
    g_img: torch.Tensor,  # [T, P, 3] f32 image cotangent, tile-major
    g_t: torch.Tensor,  # [T, P] f32 final-transmittance cotangent
    t_fin: torch.Tensor,  # [T, P] f32 the forward's final T
    last: torch.Tensor,  # [T, P] i32 the forward's last contributor
):
    """Per-intersection gradient rows [I, 16] f32, summed over each tile's
    pixels; rows no tile walks are zero. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if feats.device.type == "cpu":
        return tiled_backward_plain(feats, tile_offsets, basis, g_img, g_t, t_fin, last)
    dev = feats.device
    tensors = (feats, tile_offsets, basis, g_img, g_t, t_fin, last)
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("tiled_backward: all inputs must be on one CUDA device")
    if any(x.dtype != torch.float32 for x in (feats, basis, g_img, g_t, t_fin)):
        raise ValueError("tiled_backward: feats, basis, g_img, g_t and t_fin must be f32")
    if tile_offsets.dtype != torch.int32 or last.dtype != torch.int32:
        raise ValueError("tiled_backward: tile_offsets and last must be i32")
    if feats.dim() != 2 or feats.shape[1] != NUM_FEATURES:
        raise ValueError(f"tiled_backward: feats must be [I, 16], got {tuple(feats.shape)}")
    p = basis.shape[0]
    num_tiles = tile_offsets.shape[0] - 1
    if basis.shape != (p, 8) or not 0 < p <= MAX_TILE_PIXELS:
        raise ValueError(
            f"tiled_backward: basis must be [P, 8] with P <= {MAX_TILE_PIXELS}, "
            f"got {tuple(basis.shape)}"
        )
    if (
        g_img.shape != (num_tiles, p, 3)
        or any(x.shape != (num_tiles, p) for x in (g_t, t_fin, last))
    ):
        raise ValueError(
            f"tiled_backward: g_img must be [T, P, 3] and g_t, t_fin, last [T, P] "
            f"with T = {num_tiles}, P = {p}"
        )
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("tiled_backward: inputs must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("tiled_backward: feats must be 16-byte aligned")
    if num_tiles == 0:
        return torch.zeros((feats.shape[0], NUM_GRAD_COLS), dtype=torch.float32, device=dev)
    # the kernel writes every row, zeros where no tile walks
    out = torch.empty((feats.shape[0], NUM_GRAD_COLS), dtype=torch.float32, device=dev)
    lib = _build.load("tile_backward")
    fn = lib.egs_tile_backward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p]
    )
    err = fn(
        feats.data_ptr(), tile_offsets.data_ptr(), basis.data_ptr(), num_tiles, p,
        warp_block_side(p), feats.shape[0], _cull_constants(), g_img.data_ptr(), g_t.data_ptr(),
        t_fin.data_ptr(), last.data_ptr(),
        out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tiled_backward kernel launch failed: CUDA error {err}")
    global backward_launches
    backward_launches += 1
    return out
