"""The port's screen-space projection in float32, in its own order of
operations: a frozen copy of ``easy_gaussian_splatting_torch/ops/
projection.py`` (``_camera_covar_upper``, ``project_gaussians``) and the
activations of ``models/render.py``, from commit
cecd31169c04ec6e0b647a102e329261f797bf62.

The reference takes from it the binning's decisions alone: which tiles
list which Gaussian, and in which depth order. Every value it composites
and differentiates comes from ``render.splats``, in float64. The port's
binning is not continuous: a Gaussian too large for its window of
``max_tiles``^2 tiles is cut to a window whose shape and place follow from
``floor`` of its extent over the tile size, so an extent within rounding
of a tile boundary moves a whole column of the window (seen: a near
Gaussian of radius 80 pixels whose lower edge fell at 288.00 pixels, 0.41
of colour in 4,327 pixels). Taking those decisions on the bits the program
rounds to leaves the comparison to judge the values. Imports nothing of
the port.
"""

from __future__ import annotations

from typing import Dict

import torch

from .render import Splats

NEAR_PLANE = 0.01
FAR_PLANE = 1e10
EPS2D = 0.3
RADIUS_CLIP = 0.0


class _Intrinsics:
    def __init__(self, K, width, height):
        self.fx, self.fy, self.cx, self.cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        self.width, self.height = width, height


def _bound(x, v):
    return v if isinstance(v, torch.Tensor) else torch.full((), v, dtype=x.dtype, device=x.device)


def maximum(x, lo):
    return torch.maximum(x, _bound(x, lo))


def minimum(x, hi):
    return torch.minimum(x, _bound(x, hi))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def _camera_covar_upper(quats, scales, R_cw, eps: float = 1e-12):
    """Upper triangle (s00,s01,s02,s11,s12,s22) of R_cw (R S S^T R^T) R_cw^T
    as six [N] tensors, expanded elementwise like the JAX version."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    q = quats / maximum(norm, eps)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)),
        (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)),
        (2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    Q = [
        [
            R_cw[i, 0] * r[0][j] + R_cw[i, 1] * r[1][j] + R_cw[i, 2] * r[2][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    s2 = scales * scales
    s2c = (s2[:, 0], s2[:, 1], s2[:, 2])

    def entry(i, l):
        return (
            s2c[0] * Q[i][0] * Q[l][0]
            + s2c[1] * Q[i][1] * Q[l][1]
            + s2c[2] * Q[i][2] * Q[l][2]
        )

    return entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2)


def project_gaussians(
    means: torch.Tensor,  # [N, 3] world
    quats: torch.Tensor,  # [N, 4] wxyz (unnormalized ok)
    scales: torch.Tensor,  # [N, 3] positive
    w2c: torch.Tensor,  # [4, 4]
    intr,
    near_plane: float = NEAR_PLANE,
    far_plane: float = FAR_PLANE,
    eps2d: float = EPS2D,
    radius_clip: float = RADIUS_CLIP,
):
    """Project 3D Gaussians to screen space (EWA splatting)."""
    R_cw = w2c[:3, :3]
    t_cw = w2c[:3, 3]

    mx, my_, mz = means[:, 0], means[:, 1], means[:, 2]
    x = R_cw[0, 0] * mx + R_cw[0, 1] * my_ + R_cw[0, 2] * mz + t_cw[0]
    y = R_cw[1, 0] * mx + R_cw[1, 1] * my_ + R_cw[1, 2] * mz + t_cw[1]
    z = R_cw[2, 0] * mx + R_cw[2, 1] * my_ + R_cw[2, 2] * mz + t_cw[2]
    zsafe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)

    s00, s01, s02, s11, s12, s22 = _camera_covar_upper(quats, scales, R_cw)

    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy
    tan_fovx = 0.5 * intr.width / fx
    tan_fovy = 0.5 * intr.height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = clip(x / zsafe, -lim_x, lim_x) * z
    ty = clip(y / zsafe, -lim_y, lim_y) * z

    rz = 1.0 / zsafe
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    c00 = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    c01 = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c11 = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    c00 = c00 + eps2d
    c11 = c11 + eps2d

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det <= 0.0, torch.ones_like(det), det)
    conic = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe], dim=-1)

    b = 0.5 * (c00 + c11)
    v1 = b + torch.sqrt(maximum(b * b - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    mean2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)

    valid = (z > near_plane) & (z < far_plane) & (det > 0.0)
    inside = (
        (mean2d[:, 0] + radius > 0.0)
        & (mean2d[:, 0] - radius < intr.width)
        & (mean2d[:, 1] + radius > 0.0)
        & (mean2d[:, 1] - radius < intr.height)
    )
    valid = valid & inside & (radius > radius_clip)
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    return mean2d, conic, z, radius


def binning32(params: Dict[str, torch.Tensor], w2c: torch.Tensor, K: torch.Tensor,
              width: int, height: int) -> Splats:
    """Screen-space Gaussians of ``params`` (alive rows) rounded to float32,
    as the port's render computes them before its binning; no colours."""
    p = {k: v.detach().to(torch.float32) for k, v in params.items()}
    w2c, K = w2c.to(torch.float32), K.to(torch.float32)
    scales = torch.exp(p["log_scales"])
    opacities = torch.sigmoid(p["logit_opacities"])
    means2d, conics, depths, radii = project_gaussians(
        p["means"], p["quats"], scales, w2c, _Intrinsics(K, width, height))
    opac_eff = opacities * (radii > 0.0).to(torch.float32)
    radii = torch.where(opac_eff > 0.0, radii, torch.zeros_like(radii))
    return Splats(means2d, conics, None, opac_eff, depths, radii)
