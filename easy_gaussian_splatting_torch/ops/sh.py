"""Real spherical-harmonics colour evaluation, degrees 0..3; counterpart
of ``easy_gaussian_splatting_tpu/ops/sh.py`` (same constants, same
flattened-coefficient layout)."""

from __future__ import annotations

import torch

from .clip import maximum

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh0(rgb):
    """RGB in [0,1] -> degree-0 SH coefficient (tensor or numpy array)."""
    return (rgb - 0.5) / C0


def sh0_to_rgb(sh0):
    return sh0 * C0 + 0.5


def eval_sh_flat(
    degree: int,
    sh0: torch.Tensor,  # [N, 3]
    sh_rest: torch.Tensor,  # [N, 3*(K-1)] = reshape of [N, K-1, 3]
    dirs: torch.Tensor,  # [N, 3] unit view directions
) -> torch.Tensor:
    """Raw SH colours [N, 3] at the given degree (the caller adds 0.5 and
    clamps, see :func:`eval_sh_color_flat`)."""
    if degree < 0 or degree > 3:
        raise ValueError(f"degree must be in [0, 3], got {degree}")
    result = C0 * sh0

    def blk(k: int) -> torch.Tensor:  # rest-coefficient k-1 (k >= 1)
        j = 3 * (k - 1)
        return sh_rest[:, j : j + 3]

    if degree >= 1:
        x = dirs[:, 0:1]
        y = dirs[:, 1:2]
        z = dirs[:, 2:3]
        result = (
            result - C1 * y * blk(1) + C1 * z * blk(2) - C1 * x * blk(3)
        )
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (
            result
            + C2[0] * xy * blk(4)
            + C2[1] * yz * blk(5)
            + C2[2] * (2.0 * zz - xx - yy) * blk(6)
            + C2[3] * xz * blk(7)
            + C2[4] * (xx - yy) * blk(8)
        )
    if degree >= 3:
        result = (
            result
            + C3[0] * y * (3.0 * xx - yy) * blk(9)
            + C3[1] * xy * z * blk(10)
            + C3[2] * y * (4.0 * zz - xx - yy) * blk(11)
            + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * blk(12)
            + C3[4] * x * (4.0 * zz - xx - yy) * blk(13)
            + C3[5] * z * (xx - yy) * blk(14)
            + C3[6] * x * (xx - 3.0 * yy) * blk(15)
        )
    return result


def eval_sh_color_flat(
    degree: int, sh0: torch.Tensor, sh_rest: torch.Tensor, dirs: torch.Tensor
) -> torch.Tensor:
    """SH -> clamped RGB, the rasterizer's post-processing
    ``max(eval + 0.5, 0)``."""
    return maximum(eval_sh_flat(degree, sh0, sh_rest, dirs) + 0.5, 0.0)
