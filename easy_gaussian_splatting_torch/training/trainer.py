"""Renderer selection and the inference binning autotune; counterpart of
``get_render_fn`` and ``tune_inference_cfg`` in
``easy_gaussian_splatting_tpu/training/trainer.py``. The train step and
loop come with the training part of the port."""

from __future__ import annotations

import functools
import logging
import math
from typing import Callable

import numpy as np
import torch

from ..models.render import render
from .config import Config

logger = logging.getLogger(__name__)


def get_render_fn(cfg: Config) -> Callable:
    """The tiled renderer (the production path) or the exact O(N*P) oracle."""
    if cfg.renderer == "tiled":
        from ..ops.rasterize_tiled import make_tiled_render_fn

        return make_tiled_render_fn(
            tile_size=cfg.tile_size,
            max_tiles_w=cfg.max_tiles,
            max_tiles_h=cfg.max_tiles,
            isect_mult=cfg.isect_mult,
            ov_frac=cfg.ov_frac,
            small_budget=cfg.small_budget,
        )
    return functools.partial(render, chunk=cfg.raster_chunk)


def tune_inference_cfg(
    cfg: Config, state, w2c, K, height: int, width: int, margin: float = 1.5,
) -> Config:
    """Right-size the binning parameters for a loaded checkpoint from one
    probe frame at the given camera: the intersection capacity
    (``isect_mult``, with ``margin`` over the probe's count, inside the
    memory budget) and the population split (``small_budget``, ``ov_frac``)
    with the smallest sort domain. A dumped ``config.yaml`` carries the
    pre-autotune defaults, which are oversized at end-of-training
    populations."""
    if cfg.renderer != "tiled":
        return cfg
    from ..ops.rasterize_tiled import (
        BUDGET_CANDIDATES,
        _ov_capacity,
        make_isect_counter,
        max_isect_cap,
    )

    device = state.params.means.device
    counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles)
    vals = counter(
        state.params, state.alive,
        torch.as_tensor(np.asarray(w2c), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device),
        height=height, width=width,
    ).cpu().numpy()
    cap = state.capacity
    n = int(vals[0])
    max_mult = max_isect_cap(cfg.isect_hbm_budget_mb) / max(cap, 1)
    cfg.isect_mult = (
        math.floor(min(max(0.25, n * margin / cap), max_mult) * 1e3) / 1e3
    )
    m_cells = cfg.max_tiles * cfg.max_tiles
    best_dom = None
    for bb, need in zip(BUDGET_CANDIDATES, vals[2:]):
        if bb >= m_cells:
            continue
        ovf = round(max(0.01, min(1.0, int(need) * 2.0 / cap)), 3)
        dom = cap * bb + m_cells * _ov_capacity(cap, ovf)
        if best_dom is None or dom < best_dom:
            cfg.small_budget, cfg.ov_frac, best_dom = bb, ovf, dom
    logger.info(
        f"inference binning autotune: {n} isects at capacity {cap} -> "
        f"isect_mult {cfg.isect_mult}, small_budget {cfg.small_budget}, "
        f"ov_frac {cfg.ov_frac}"
    )
    return cfg
