"""Forward render of a Gaussian model for one camera; counterpart of
``easy_gaussian_splatting_tpu/models/render.py``: activations (exp
scales, sigmoid opacities), EWA projection, SH colour along the
camera->Gaussian direction (``ops/kernels/sh_color.py``), one rasterizer
call with a background colour, and a [0, 1] clamp on the image. The
returned ``radii`` and the gradient of ``absgrad_dummy`` (the absgrad side
channel) feed ``update_statistics``."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.clip import clip
from ..ops.kernels.sh_color import sh_color
from ..ops.projection import CameraIntrinsics, project_gaussians
from ..ops.rasterize_ref import rasterize
from ..ops.sh import eval_sh_color_flat
from .gaussians import GaussianParams


class CameraView(NamedTuple):
    """One camera: world->camera transform and intrinsics, as f32 tensors
    on the render's device, and the image size.

    ``full_height``/``y_offset`` select a horizontal stripe of a taller
    viewport (the multi-device path, ``parallel/shard.py``): projection (the
    EWA Jacobian's frustum clamp and the visibility cull) runs in the full
    image's geometry, so every rank sees the same conics and radii, then the
    screen means shift up by ``y_offset`` rows into the stripe and only
    ``height`` rows are rasterized. ``y_limit`` (0-d, rows) bins only rows
    ``[0, y_limit)`` of that window (the adaptive partition); the oracle
    ignores it, as the JAX oracle does."""

    w2c: torch.Tensor  # [4, 4]
    K: torch.Tensor  # [3, 3]
    width: int
    height: int  # rasterized rows (the stripe's when sharded)
    full_height: int | None = None  # projection viewport rows (None: height)
    y_offset: torch.Tensor | None = None  # 0-d f32: the stripe's first row
    y_limit: torch.Tensor | None = None  # 0-d f32: rows that receive content


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
    # H, W, radii=...[, y_limit=...]) -> (img, alpha[, num_isects]); default:
    # the oracle
) -> RenderOutput:
    scales = torch.exp(params.log_scales)
    opacities = torch.sigmoid(params.logit_opacities) * alive.to(torch.float32)

    proj_h = camera.height if camera.full_height is None else camera.full_height
    intr = CameraIntrinsics.from_K(camera.K, camera.width, proj_h)
    proj = project_gaussians(params.means, params.quats, scales, camera.w2c, intr)
    if camera.y_offset is not None:  # stripe-local rows (see CameraView)
        shift = torch.stack([torch.zeros_like(camera.y_offset), camera.y_offset])
        proj = proj._replace(means2d=proj.means2d - shift[None, :])

    # one kernel each way on the card; on the CPU the plain ops, whose SH
    # step is this module's `eval_sh_color_flat`, looked up at each call
    colors = sh_color(sh_degree, params.means, params.sh_0, params.sh_rest, camera.w2c,
                      sh_eval=eval_sh_color_flat)

    opac_eff = opacities * (proj.radii > 0.0).to(torch.float32)
    if rasterizer is None:
        rasterizer = functools.partial(rasterize, chunk=chunk)
    kw = {} if camera.y_limit is None else {"y_limit": camera.y_limit}
    out = rasterizer(
        proj.means2d, proj.conics, colors, opac_eff, proj.depths, background,
        absgrad_dummy, camera.height, camera.width, radii=proj.radii, **kw,
    )
    img, alpha = out[0], out[1]
    num_isects = out[2] if len(out) > 2 else None
    return RenderOutput(
        image=clip(img, 0.0, 1.0), alpha=alpha, radii=proj.radii,
        num_isects=num_isects,
    )
