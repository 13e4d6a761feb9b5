"""Segmented suffix sums of gradient rows: the CUDA kernel
``csrc/segsum_band.cu`` and its plain PyTorch version.

Counterpart of ``easy_gaussian_splatting_tpu/ops/pallas/segments.py::
segsum_band``. Rows are the tiled backward's f32 gradient rows [n, 16]
gathered into ascending flat-id order; ``g`` [n] i32 are their
non-decreasing group ids (the Gaussian index). ``out[i]`` is the sum of
``rows[j]`` over ``j`` in ``[i, i + LOOK)`` while ``g[j] == g[i]``, so each
group's total lands on its first row. Unlike the TPU kernel (which compares
ids as f32, exact only below 2^24, and pads the rows to its block size),
ids are compared as integers and any row count is taken.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LOOK = 128  # longest group summed in full (max_tiles^2 <= LOOK)
NUM_COLS = 16

# kernel launches made by `segsum_band` (the plain version never counts)
launches = 0


def segsum_band_plain(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Log-step segmented suffix scan: after the shift-k step each row holds
    the sum over its group's rows in ``[i, i + 2k)``; shifts 1, 2, ..., 64
    cover ``LOOK`` rows. Every step adds neighbours of similar size, so
    millions of rows do not cancel as a global cumulative sum would."""
    n = rows.shape[0]
    out = rows
    k = 1
    while k < LOOK:
        if k >= n:
            break
        same = torch.zeros(n, dtype=torch.bool, device=rows.device)
        same[: n - k] = g[k:] == g[: n - k]
        ahead = torch.zeros_like(out)
        ahead[: n - k] = out[k:]
        out = out + torch.where(same[:, None], ahead, torch.zeros_like(ahead))
        k *= 2
    return out


def segsum_band(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Segmented suffix sums [n, 16] f32 of group-sorted rows. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if rows.device.type == "cpu":
        return segsum_band_plain(rows, g)
    dev = rows.device
    if dev.type != "cuda" or g.device != dev:
        raise ValueError("segsum_band: rows and g must be on one CUDA device")
    if rows.dtype != torch.float32 or g.dtype != torch.int32:
        raise ValueError("segsum_band: rows must be f32 and g i32")
    n = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] != NUM_COLS or g.shape != (n,):
        raise ValueError(
            f"segsum_band: rows must be [n, {NUM_COLS}] and g [n], got "
            f"{tuple(rows.shape)} and {tuple(g.shape)}"
        )
    if not (rows.is_contiguous() and g.is_contiguous()):
        raise ValueError("segsum_band: inputs must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError("segsum_band: rows must be 16-byte aligned")
    out = torch.empty_like(rows)
    if n == 0:
        return out
    lib = _build.load("segsum_band")
    fn = lib.egs_segsum_band
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        rows.data_ptr(), g.data_ptr(), n, LOOK, out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum_band kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
