"""Forward render of a Gaussian model for one camera; counterpart of
``easy_gaussian_splatting_tpu/models/render.py``: activations (exp
scales, sigmoid opacities), EWA projection, SH colour along the
camera->Gaussian direction, one rasterizer call with a background colour,
and a [0, 1] clamp on the image. The returned ``radii`` and the gradient of
``absgrad_dummy`` (the absgrad side channel) feed ``update_statistics``."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.clip import clip, maximum
from ..ops.projection import CameraIntrinsics, project_gaussians
from ..ops.rasterize_ref import rasterize
from ..ops.sh import eval_sh_color_flat
from .gaussians import GaussianParams


class CameraView(NamedTuple):
    """One camera: world->camera transform and intrinsics, as f32 tensors
    on the render's device, and the image size."""

    w2c: torch.Tensor  # [4, 4]
    K: torch.Tensor  # [3, 3]
    width: int
    height: int


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [H, W, 3] clamped to [0, 1]
    alpha: torch.Tensor  # [H, W]
    radii: torch.Tensor  # [C] screen radii in pixels, 0 => culled
    # binned intersection count (tiled rasterizer only; None for the oracle)
    num_isects: torch.Tensor | None = None


def render(
    params: GaussianParams,
    alive: torch.Tensor,  # [C] bool
    camera: CameraView,
    sh_degree: int,
    background: torch.Tensor,  # [3]
    absgrad_dummy: torch.Tensor | None = None,  # [C, 2] zeros; its gradient
    # is absgrad (None: forward only, as the viewer renders)
    chunk: int = 256,
    rasterizer=None,  # (m2d, conics, colors, opac, depths, bg, absdummy,
    # H, W, radii=...) -> (img, alpha[, num_isects]); default: the oracle
) -> RenderOutput:
    scales = torch.exp(params.log_scales)
    opacities = torch.sigmoid(params.logit_opacities) * alive.to(torch.float32)

    intr = CameraIntrinsics.from_K(camera.K, camera.width, camera.height)
    proj = project_gaussians(params.means, params.quats, scales, camera.w2c, intr)

    r_cw = camera.w2c[:3, :3]
    t_cw = camera.w2c[:3, 3]
    cam = [
        -(r_cw[0, j] * t_cw[0] + r_cw[1, j] * t_cw[1] + r_cw[2, j] * t_cw[2])
        for j in range(3)
    ]
    dirs = torch.stack([params.means[:, j] - cam[j] for j in range(3)], dim=1)
    dirs = dirs / maximum(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    c = params.sh_0.shape[0]
    colors = eval_sh_color_flat(
        sh_degree, params.sh_0.reshape(c, 3), params.sh_rest.reshape(c, -1), dirs
    )

    opac_eff = opacities * (proj.radii > 0.0).to(torch.float32)
    if rasterizer is None:
        rasterizer = functools.partial(rasterize, chunk=chunk)
    out = rasterizer(
        proj.means2d, proj.conics, colors, opac_eff, proj.depths, background,
        absgrad_dummy, camera.height, camera.width, radii=proj.radii,
    )
    img, alpha = out[0], out[1]
    num_isects = out[2] if len(out) > 2 else None
    return RenderOutput(
        image=clip(img, 0.0, 1.0), alpha=alpha, radii=proj.radii,
        num_isects=num_isects,
    )
