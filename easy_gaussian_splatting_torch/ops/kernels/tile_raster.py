"""Tiled forward compositing: the CUDA kernel ``csrc/tile_forward.cu`` and
its plain PyTorch version.

Counterpart of ``easy_gaussian_splatting_tpu/ops/pallas/tile_raster.py::
tiled_forward``. Features are row-major ``[I, 16]`` (one row per
intersection, columns as in ``rasterize_tiled.pack_features``) rather
than the TPU's feature-major ``[16, I_pad]``; the math and the decoded
outputs are the same: rgb [T, P, 3], final transmittance [T, P] and the
global index of each pixel's last composited intersection [T, P] (-1 if
none). The backward kernel comes with the training part of the port.
"""

from __future__ import annotations

import ctypes

import torch

from ..rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, T_EPS
from . import _build

NUM_FEATURES = 16
# slack on the tile-local polynomial's sigma >= 0 test: its expansion
# carries ~1e-4 cancellation error near a Gaussian's center
SIGMA_EPS = 1e-3
ROW_OPACITY = 6  # -log(opacity), multiplied by basis column 6 (= 1)
ROW_COLOR = 8
MAX_TILE_PIXELS = 1024  # one thread per pixel in a block
# (pixel, intersection) pairs per batch of tiles in the plain version
PLAIN_BATCH_PAIRS = 1 << 26

# kernel launches made by `tiled_forward` (the plain version never counts)
launches = 0


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
    basis7 = basis[:, :7]
    t0 = 0
    while t0 < num_tiles:
        t1, longest = t0 + 1, counts_h[t0]
        while t1 < num_tiles:
            wider = max(longest, counts_h[t1])
            if (t1 - t0 + 1) * p * wider > PLAIN_BATCH_PAIRS:
                break
            longest, t1 = wider, t1 + 1
        if longest > 0:
            lane = torch.arange(longest, device=device)
            starts = offs[t0:t1, None]
            in_range = lane[None, :] < (offs[t0 + 1 : t1 + 1, None] - starts)
            idx = torch.where(in_range, starts + lane[None, :], torch.zeros_like(starts))
            f = feats[idx]  # [B, L, 16]
            s2 = torch.matmul(basis7, f[..., :7].transpose(1, 2))  # [B, P, L]
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
        t0 = t1
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
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    err = fn(
        feats.data_ptr(), tile_offsets.data_ptr(), basis.data_ptr(),
        num_tiles, p, rgb.data_ptr(), t_fin.data_ptr(), last.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tiled_forward kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return rgb, t_fin, last
