"""Viewer <-> model integration; counterpart of
``easy_gaussian_splatting_tpu/viewer/integration.py``: load
``cameras.json``, build the render closure the viewer serves, and build the
training viewer (the closure over the loop's live state behind a
``DelayRender`` mailbox)."""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import List

import numpy as np
import torch

from .camera import CameraState
from .server import Viewer

logger = logging.getLogger(__name__)


def load_camera_states(path: Path) -> List[CameraState]:
    camera_states = []
    with open(Path(path) / "cameras.json", "r") as f:
        for cam in json.load(f):
            c2w = np.eye(4)
            c2w[:3, :3] = np.array(cam["rotation"])
            c2w[:3, 3] = np.array(cam["position"])
            w2c = np.linalg.inv(c2w)
            K = np.array(
                [
                    [cam["fx"], 0, cam["width"] / 2],
                    [0, cam["fy"], cam["height"] / 2],
                    [0, 0, 1],
                ],
                np.float32,
            )
            camera_states.append(CameraState(w2c, K, cam["width"], cam["height"]))
    return camera_states


def capacity_scale(pixels: int, base_pixels: int) -> float:
    """Intersection-capacity scale of a ``pixels``-sized frame against the
    probe frame the capacity was tuned at: intersection counts grow about
    linearly with pixels. Below the probe size it is the JAX viewer's
    scale (1.5x headroom over the linear estimate, capped at 1); above it,
    the linear scale itself, where the JAX viewer stays at 1 and truncates
    tiles. The caller clamps the result to the memory budget."""
    ratio = pixels / base_pixels
    return max(min(1.0, ratio * 1.5 + 0.05), ratio)


def make_gs_render_func(get_state, get_sh_degree, background, render_fn,
                        cfg=None, base_pixels=None):
    """Render closure over model state; ``get_state`` / ``get_sh_degree``
    are callables so the latest state is picked up.

    With ``cfg`` + ``base_pixels`` (the offline viewer), the intersection
    capacity is sized per frame size: first by :func:`capacity_scale`,
    clamped to ``max_isect_cap``; a frame whose intersections exceed its
    capacity is rendered again with the capacity grown to 1.5x its count
    (within ``max_isect_cap``), which that frame size keeps. Intersection
    counts scale less than linearly at small sizes, where most Gaussians
    cover one tile. Each frame's count, capacity and re-render count land
    in the closure's ``stats``."""
    from ..models.render import CameraView
    from ..ops.rasterize_tiled import isect_capacity, max_isect_cap
    from ..training.trainer import get_render_fn

    tiled = cfg is not None and bool(base_pixels) and cfg.renderer == "tiled"
    mults = {}  # (width, height, capacity) -> isect_mult

    def render(state, camera, sh, mult):
        rf = get_render_fn(dataclasses.replace(cfg, isect_mult=mult)) if tiled else render_fn
        return rf(state.params, state.alive, camera, sh, background)

    @torch.no_grad()
    def gs_render_func(camera_state: CameraState) -> np.ndarray:
        state = get_state()
        sh = int(get_sh_degree())
        cap = getattr(camera_state, "sh_cap", None)
        if cap is not None:
            # interactive degradation: the client caps the SH degree while
            # the camera moves
            sh = min(sh, int(cap))
        width, height = int(camera_state.width), int(camera_state.height)
        device = state.params.means.device
        camera = CameraView(
            w2c=torch.as_tensor(camera_state.w2c, dtype=torch.float32, device=device),
            K=torch.as_tensor(camera_state.K, dtype=torch.float32, device=device),
            width=width,
            height=height,
        )
        if not tiled:
            return render(state, camera, sh, None).image.cpu().numpy()
        key = (width, height, state.capacity)
        max_mult = max_isect_cap(cfg.isect_hbm_budget_mb) / state.capacity
        if key not in mults:
            scale = capacity_scale(width * height, base_pixels)
            mults[key] = min(max(0.25, cfg.isect_mult * scale), max_mult)
        retries = 0
        while True:
            out = render(state, camera, sh, mults[key])
            n = int(out.num_isects)
            icap = isect_capacity(state.capacity, mults[key])
            grown = min(n * 1.5 / state.capacity, max_mult)
            if n <= icap or retries or grown <= mults[key]:
                break
            logger.warning(
                f"{width}x{height} frame: {n} intersections > capacity {icap}; "
                "rendering again with a larger capacity"
            )
            mults[key] = grown
            retries += 1
        if n > icap:
            logger.warning(f"{width}x{height} frame truncated: {n} > capacity {icap}")
        gs_render_func.stats = dict(
            width=width, height=height, num_isects=n, isect_cap=icap,
            rerenders=retries,
        )
        return out.image.cpu().numpy()

    gs_render_func.stats = {}
    return gs_render_func


def construct_training_viewer(loop, cfg, output_dir: Path, port: int = 9981) -> Viewer:
    """The viewer ``train()`` serves with ``view_online``: the render closure
    over ``loop``'s live model and SH degree, in training mode (requests go
    to the mailbox the loop renders from). Unlike the JAX package's, the
    closure sizes the intersection capacity per frame size from the live
    ``cfg`` and renders a frame again when it overflows, as the offline
    viewer does; ``port=0`` binds a free port (``Viewer.port``)."""
    from ..training.trainer import get_render_fn

    camera_states = load_camera_states(output_dir)
    device = loop.model.alive.device
    background = torch.full(
        (3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32, device=device
    )
    base_px = (
        int(camera_states[0].width) * int(camera_states[0].height)
        if camera_states else None
    )
    render_func = make_gs_render_func(
        lambda: loop.model,
        lambda: loop.active_sh_degree,
        background,
        get_render_fn(cfg),
        cfg=cfg,
        base_pixels=base_px,
    )
    return Viewer(
        render_func,
        camera_states,
        port=port,
        in_training_mode=True,
        video_output_dir=output_dir / "videos",
    )
