"""The yardstick: the card's peaks, the least bytes and operations a train
step and a tile kernel need, and the names by which the profiler's kernels
are sorted into layers.

Frozen copies, made at commit cecd31169c04ec6e0b647a102e329261f797bf62:
the peaks, the per-pair operation counts, ``bound_ms`` (here ``bound_s``),
``forward_bound``, ``backward_bound`` and ``KERNEL_SYMBOLS`` from
``chip_smoke.py``; ``step_bytes`` is ``easy_gaussian_splatting_torch/
bench.py``'s ``sol_bytes`` per-item byte model, counted over what the
algorithm needs. Every bound takes counts that the plain reference makes
from the inputs (``reference/render.py``), not the program's buffers: the
alive Gaussians, the image's own pixels and the live intersection rows
only. Dead slots and the padding the program's binning adds are work the
algorithm does not need, and would move with the program's tuning.
Nothing here imports the program.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM5 data sheet (dense rates): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores, at the card's 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# f32 operations per composited (pixel, intersection) pair, counted from the
# kernels' sources (chip_smoke.py): the forward's eligibility test (~20),
# 1 - alpha, the new T, the stop test, the weight and three multiply-adds;
# the backward's eligibility test, ~39 of gradient math and 11 adds
FORWARD_OPS_PER_COMPOSITED = 30
BACKWARD_OPS_PER_COMPOSITED = 70
# per Gaussian, forward (the backward counts twice): activations (three
# exp, the sigmoid, the alive mask); the EWA projection (world to camera,
# quaternion to rotation, the 3D covariance in camera axes, the Jacobian,
# the 2D covariance, conic, radius, screen mean, the culls); colour from
# SH degree 3 (the direction and its norm, 16 bases, 48 multiply-adds,
# the clamp)
ACTIVATION_OPS = 10
PROJECTION_OPS = 240
SH3_OPS = 150
# Adam per parameter value: both moments, the bias corrections, the square
# root, the division, eps, the learning rate and the update; 59 values a
# Gaussian (means 3, log-scales 3, quaternion 4, SH 48, opacity 1)
ADAM_OPS = 14
PARAMS_PER_GAUSSIAN = 59
# the loss per pixel and channel: L1 (3 forward, 2 backward); SSIM's three
# product maps, the per-pixel formula (~20) and an 11-tap separable
# Gaussian blur of its five maps (two passes of 11 multiply-adds)
SSIM_TAPS = 11
SSIM_MAPS = 5
SSIM_FORMULA_OPS = 20

# each of the port's kernels by the name of its __global__ function
KERNEL_SYMBOLS = {
    "binkeys": "binkeys_kernel", "tiled_forward": "tile_forward_kernel",
    "tiled_backward": "tile_backward_kernel", "segsum_band": "segsum_band_kernel",
    "segsum_compact": "segsum_compact_kernel", "monotone_expand": "monotone_expand_kernel",
    "group_reduce": "group_reduce_kernel",
}
# library kernels by name: matrix products (cuBLAS, CUTLASS) and sorts (CUB)
GEMM_PATTERN = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)
SORT_PATTERN = re.compile(r"sort", re.IGNORECASE)


def port_kernel(name: str) -> str | None:
    """The port's kernel a profiler record's name belongs to, or None."""
    for kernel, sym in KERNEL_SYMBOLS.items():
        if re.search(rf"\b{sym}\b", name):
            return kernel
    return None


def bound_s(nbytes: float, ops: float) -> float:
    """The least time on the card: the larger of the byte and the operation
    bound."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


def step_bytes(n_alive: int, live_rows: int, height: int, width: int) -> int:
    """The bytes one view's train step must move at the least: the alive
    Gaussians' parameters and Adam state (forward and backward reads, the
    update's read and write), each live intersection row's features
    (packed, read by both kernels) and gradient row (written, read by the
    reduction), one pass of a sort over the live rows (key and payload, read
    and write), and the loss images."""
    return (n_alive * (236 * 2 + 236 * 2 + 472 * 2)
            + live_rows * (64 * 3 + 48 * 3 + 16)
            + height * width * 3 * 4 * 6)


def loss_ops(height: int, width: int) -> int:
    """L1 + SSIM over an image, forward and backward (the backward twice the
    forward's blur and formula)."""
    px = height * width * 3
    hv, wv = height - SSIM_TAPS + 1, width - SSIM_TAPS + 1
    blur = SSIM_MAPS * 3 * 2 * SSIM_TAPS * (height * wv + hv * wv)
    forward = 3 * px + 3 * px + blur + SSIM_FORMULA_OPS * hv * wv * 3
    return forward + 2 * px + 2 * (blur + SSIM_FORMULA_OPS * hv * wv * 3)


def step_ops(n_alive: int, height: int, width: int, composited: int) -> int:
    """The operations one view's train step needs (SH degree 3): the
    per-Gaussian forward and its backward over the alive Gaussians, the
    compositing of the composited pairs forward and backward, the loss and
    Adam."""
    per_gauss = ACTIVATION_OPS + PROJECTION_OPS + SH3_OPS
    return (3 * per_gauss * n_alive
            + (FORWARD_OPS_PER_COMPOSITED + BACKWARD_OPS_PER_COMPOSITED) * composited
            + loss_ops(height, width)
            + ADAM_OPS * PARAMS_PER_GAUSSIAN * n_alive)


def forward_bound_s(counts: dict) -> float:
    """``tiled_forward``'s least time on one frame: each feature row some
    pixel of its tile reaches read once (64 bytes), the tile offsets and
    the pixel basis, the outputs (rgb, T, last: 20 bytes a pixel) written
    once; the operations of the composited pairs."""
    t, p = counts["tiles"], counts["tile_pixels"]
    nbytes = counts["walk_rows"] * 64 + (t + 1) * 4 + p * 32 + counts["pixels"] * 20
    return bound_s(nbytes, FORWARD_OPS_PER_COMPOSITED * counts["composited"])


def backward_bound_s(counts: dict) -> float:
    """``tiled_backward``'s least time on one view: the live feature rows
    read and their gradient rows (16 f32) written once, the offsets and
    basis, the cotangents (rgb and T), T and last read once; the operations
    of the composited pairs."""
    t, p = counts["tiles"], counts["tile_pixels"]
    nbytes = counts["live_rows"] * (64 + 64) + (t + 1) * 4 + p * 32 + counts["pixels"] * 24
    return bound_s(nbytes, BACKWARD_OPS_PER_COMPOSITED * counts["composited"])
