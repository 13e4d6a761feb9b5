"""The training loop and the train step; counterpart of
``easy_gaussian_splatting_tpu/training/trainer.py``.

One step is render -> loss -> backward -> statistics -> grouped Adam for
one camera; refine events (every ``refine_every`` steps) run densify and
prune with that step's weight update skipped; scalars are read back a few
steps late so the host never waits on the card. On the card (with no mesh,
or on an NCCL mesh) the step runs as a CUDA graph, one per static
signature, over buffers it updates in place (``graphs.GraphedTrainStep``,
the counterpart of the JAX step's ``jax.jit`` with donation), and so do
the refine event, the opacity reset and the intersection counters
(``densify_event``, ``reset_event``, ``counted_isects``: programs over
the step's buffers, taken by reference) and the eval's frame, whose
programs join the step's. A new capacity, SH degree or binning retune
captures a new step graph at its first step, unless the capture ahead
(``precompile.StepPrecompiler``, without a mesh) took it at the points
where the JAX trainer compiles ahead. On the CPU and on a gloo mesh (whose
collectives cannot be captured) everything runs eagerly, and ``train()``
logs why at its start; capacity compaction and a growth nothing was
prepared for stay eager everywhere, as in the JAX package.
``EGS_TORCH_LOOP_TIMING=1`` logs the loop's wall time in buckets every 100
steps, as ``EGS_TPU_LOOP_TIMING`` does.

``train(cfg)`` with no scene object builds the ``Scene`` from ``cfg.data``
(COLMAP or Blender), keeps the train and eval splits on the device
(``data_device_cache``, streaming when they do not fit its budget),
evaluates the eval frames at step 1 and every ``eval_every`` steps and
records a profiler window when ``profile_steps`` and ``output`` are set.

``view_online`` with an output directory serves the training viewer: its
HTTP threads only post the requested camera to a ``DelayRender`` mailbox,
and the loop renders the newest request once per iteration, between
steps, so the card's cadence stays the loop's, and the frame reads the
step's buffers whole. ``make_batched_train_step`` is the multi-camera step
(B views, one Adam update with the mean gradient; graphed as
``GraphedTrainStep(cfg, make_batched_train_step(cfg, render_fn), device)``);
``train()`` keeps batch 1.

``mesh_shape`` (``"tiles:N"``, ``"gauss:N"``, ``"gauss:G,tiles:T"``) trains on
a mesh of the initialised ``torch.distributed`` world, one rank a device
(``parallel/``): every rank runs ``train()`` with the same seed and config;
frames are padded to a multiple of the stripe count with the pad masked;
every decision taken on the host from a device value reads a value reduced
over the world, so the ranks stay in step. Rank 0 alone writes checkpoints,
TensorBoard, ``cameras.json`` and logs, evaluates (full single-device frames
of the gathered model, the other ranks waiting) and serves the training
viewer. Under ``gauss`` the loop holds this rank's shard and returns the
gathered state.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import math
import os
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..models.density import (
    DensifyConfig,
    densify_and_prune,
    reset_opacities,
    update_statistics,
)
from ..models.gaussians import (
    PARAM_NAMES,
    DensifyStats,
    GaussianModelState,
    GaussianParams,
    _round_up_capacity,
    compact_capacity,
    init_gaussian_state,
)
from ..models.loss import loss_dict
from ..models.optimizer import (
    AdamState,
    adam_update,
    init_adam_state,
    permute_adam_state,
    select,
)
from ..models.render import CameraView, render
from ..ops.lr_schedule import log_lerp_schedule
from .config import Config
from .graphs import GraphedTrainStep, grow_state, state_from, state_leaves, write_back
from .precompile import growth_near, growth_targets, sh_bump_due

logger = logging.getLogger(__name__)

LR_GROUPS = ("log_scales", "quats", "sh_0", "sh_rest", "logit_opacities")


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


def tuned_binning(cfg: Config, vals, capacity: int, margin: float):
    """The binning sized on one frame's intersection counts ``vals`` (an
    isect counter's: the count, the overflow count, then each budget
    candidate's need) at ``capacity``: ``isect_mult`` with ``margin`` over
    the count (floored to 1e-3, inside the memory budget), and the
    ``small_budget`` and ``ov_frac`` with the smallest sort domain (the
    config's own when no candidate fits). Returns (isect_mult, small_budget,
    ov_frac)."""
    from ..ops.rasterize_tiled import BUDGET_CANDIDATES, _ov_capacity, max_isect_cap

    n = int(vals[0])
    max_mult = max_isect_cap(cfg.isect_hbm_budget_mb) / max(capacity, 1)
    mult = math.floor(min(max(0.25, n * margin / capacity), max_mult) * 1e3) / 1e3
    m_cells = cfg.max_tiles * cfg.max_tiles
    budget, ov_frac, best_dom = cfg.small_budget, cfg.ov_frac, None
    for bb, need in zip(BUDGET_CANDIDATES, vals[2:]):
        if bb >= m_cells:
            continue
        ovf = round(max(0.01, min(1.0, int(need) * 2.0 / capacity)), 3)
        dom = capacity * bb + m_cells * _ov_capacity(capacity, ovf)
        if best_dom is None or dom < best_dom:
            budget, ov_frac, best_dom = bb, ovf, dom
    return mult, budget, ov_frac


def tune_inference_cfg(
    cfg: Config, state, w2c, K, height: int, width: int, margin: float = 1.5,
) -> Config:
    """Right-size the binning parameters for a loaded checkpoint from one
    probe frame at the given camera (``tuned_binning``). A dumped
    ``config.yaml`` carries the pre-autotune defaults, which are oversized
    at end-of-training populations."""
    if cfg.renderer != "tiled":
        return cfg
    from ..ops.rasterize_tiled import make_isect_counter

    device = state.params.means.device
    counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles)
    vals = counter(
        state.params, state.alive,
        torch.as_tensor(np.asarray(w2c), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device),
        height=height, width=width,
    ).cpu().numpy()
    cfg.isect_mult, cfg.small_budget, cfg.ov_frac = tuned_binning(cfg, vals, state.capacity, margin)
    logger.info(
        f"inference binning autotune: {int(vals[0])} isects at capacity {state.capacity} -> "
        f"isect_mult {cfg.isect_mult}, small_budget {cfg.small_budget}, "
        f"ov_frac {cfg.ov_frac}"
    )
    return cfg


def _background(cfg: Config, device) -> torch.Tensor:
    return torch.full((3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32, device=device)


def grad_leaves(params: GaussianParams, capacity: int):
    """Detached parameter leaves and a [C, 2] zero absgrad dummy, all
    requiring gradients."""
    leaves = params.map(lambda x: x.detach().requires_grad_(True))
    absd = torch.zeros((capacity, 2), dtype=torch.float32, device=params.means.device,
                       requires_grad=True)
    return leaves, absd


def cfg_loss(cfg: Config, rendered, image, mask, leaves: GaussianParams, alive):
    """The config's loss dict of a rendered image against its target."""
    return loss_dict(
        rendered, image, mask, cfg.lambda_ssim,
        log_scales=leaves.log_scales, alive=alive,
        use_scale_regularization=cfg.use_scale_regularization,
        max_scale_ratio=cfg.max_scale_ratio, lambda_scale=cfg.lambda_scale,
    )


def param_grads(total: torch.Tensor, leaves: GaussianParams, absd: torch.Tensor):
    """d total / d (each parameter in PARAM_NAMES order, then absgrad_dummy);
    a parameter the render does not reach (sh_rest at degree 0) gets zeros,
    as jax.grad gives."""
    inputs = [getattr(leaves, n) for n in PARAM_NAMES] + [absd]
    grads = torch.autograd.grad(total, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _loss_and_grads(cfg: Config, render_fn: Callable, model: GaussianModelState,
                    camera: CameraView, image, mask, sh_degree: int):
    """One camera's loss dict and pre-Adam gradients: (grads, absgrad [C, 2],
    loss dict, radii [C], num_isects or None), all detached."""
    leaves, absd = grad_leaves(model.params, model.capacity)
    out = render_fn(leaves, model.alive, camera, sh_degree,
                    _background(cfg, model.alive.device), absd)
    ld = cfg_loss(cfg, out.image, image, mask, leaves, model.alive)
    grads = param_grads(ld["total"], leaves, absd)
    return (
        GaussianParams(**dict(zip(PARAM_NAMES, grads[:-1]))),
        grads[-1],
        {k: v.detach() for k, v in ld.items()},
        out.radii.detach(),
        out.num_isects,
    )


def update_stats(stats, radii, absgrad, do_stats: bool | torch.Tensor, height: int, width: int,
                 in_place: bool = False) -> DensifyStats:
    """``stats`` with one view's observations added when ``do_stats``
    (inside the refine window). A 0-d bool tensor computes the new
    statistics and picks them with :func:`select`, as the JAX step's
    ``jnp.where`` does, with no branch on the flag, so one captured step
    serves both; a host bool computes them only when true. ``in_place``
    writes the pick into ``stats``' tensors."""
    if not isinstance(do_stats, torch.Tensor) and not do_stats:
        return stats  # what select(False, new, stats) would give
    new = update_statistics(stats, radii, absgrad, height, width)
    return DensifyStats(*(
        select(do_stats, getattr(new, f.name), getattr(stats, f.name),
               getattr(stats, f.name) if in_place else None)
        for f in dataclasses.fields(DensifyStats)))


def _view_grads(cfg: Config, render_fn: Callable, model: GaussianModelState, stats,
                w2c, K, image, mask, do_stats: bool | torch.Tensor, height: int, width: int,
                sh_degree: int, in_place: bool = False):
    """One view of a train step: its pre-Adam gradients, its loss dict (with
    the binned intersection count as ``isects``, the capacity watchdog's
    channel) and ``stats`` with this view's observations added when
    ``do_stats`` (:func:`update_stats`)."""
    camera = CameraView(w2c=w2c, K=K, width=width, height=height)
    grads, absgrad, ld, radii, num_isects = _loss_and_grads(
        cfg, render_fn, model, camera, image, mask, sh_degree
    )
    if num_isects is not None:
        ld["isects"] = num_isects.to(torch.float32)
    return grads, ld, update_stats(stats, radii, absgrad, do_stats, height, width, in_place)


def _apply_adam(cfg: Config, model: GaussianModelState, adam: AdamState, grads,
                stats, lr_means: float | torch.Tensor, skip_all: bool | torch.Tensor,
                skip_opac: bool | torch.Tensor, in_place: bool = False):
    """One grouped Adam update; a densify event skips every group, an
    opacity reset the opacities. The flags and ``lr_means`` may be 0-d
    tensors (the captured step's); ``in_place`` writes the update into the
    tensors of ``model`` and ``adam``."""
    lrs = {
        "means": lr_means,
        "log_scales": cfg.log_scales_lr,
        "quats": cfg.quats_lr,
        "sh_0": cfg.sh_0_lr,
        "sh_rest": cfg.sh_rest_lr,
        "logit_opacities": cfg.logit_opacities_lr,
    }
    skips = {name: skip_all | skip_opac if name == "logit_opacities" else skip_all
             for name in ("means",) + LR_GROUPS}
    params_new, adam_new = adam_update(model.params, grads, adam, lrs, skips, in_place)
    return GaussianModelState(params=params_new, alive=model.alive, stats=stats), adam_new


def make_train_step(cfg: Config, render_fn: Callable):
    """The single-camera train step, run eagerly. ``lr_means`` and the three
    flags may be numbers and bools on the host or 0-d tensors on the step's
    device; either way the result is the same, bit for bit. On the card
    ``train()`` runs this step through ``graphs.GraphedTrainStep``, one CUDA
    graph per signature, with the flags as 0-d tensors and ``in_place``:
    the new parameters, statistics and Adam state are written into the
    given state's tensors (its donated buffers), the same bits as the new
    tensors the step returns otherwise."""

    def train_step(
        model: GaussianModelState,
        adam: AdamState,
        w2c: torch.Tensor,
        K: torch.Tensor,
        image: torch.Tensor,
        mask: torch.Tensor,
        lr_means: float | torch.Tensor,
        do_stats: bool | torch.Tensor,  # inside the refine window
        skip_all: bool | torch.Tensor,  # densify event this step
        skip_opac: bool | torch.Tensor,  # opacity reset this step
        *,
        height: int,
        width: int,
        sh_degree: int,
        in_place: bool = False,
    ):
        grads, ld, stats = _view_grads(cfg, render_fn, model, model.stats, w2c, K, image,
                                       mask, do_stats, height, width, sh_degree, in_place)
        model_new, adam_new = _apply_adam(cfg, model, adam, grads, stats, lr_means,
                                          skip_all, skip_opac, in_place)
        return model_new, adam_new, ld

    return train_step


def make_batched_train_step(cfg: Config, render_fn: Callable):
    """The multi-camera train step: B views rendered and differentiated one
    after another, each adding its observations to the statistics (in view
    order, under ``do_stats``), then one Adam update with the mean gradient.
    The gradients are summed from zeros in view order and divided by B, as
    the JAX step's scan does. The loss dict holds each term's mean over the
    views and, as ``isects``, the worst view's intersection count.

    This is gradient accumulation, not B steps: ``train()`` keeps batch 1.
    Camera tensors are stacked on a leading B axis: ``w2cs [B,4,4]``,
    ``Ks [B,3,3]``, ``images [B,H,W,3]``, ``masks [B,H,W]``. The flags and
    ``lr_means`` may be host values or 0-d tensors, and ``in_place`` writes
    the update into the given state, as ``make_train_step``'s do; on the
    card ``graphs.GraphedTrainStep(cfg, this step, device)`` runs it as a
    CUDA graph per signature (B in it)."""

    def train_step(
        model: GaussianModelState,
        adam: AdamState,
        w2cs: torch.Tensor,
        Ks: torch.Tensor,
        images: torch.Tensor,
        masks: torch.Tensor,
        lr_means: float | torch.Tensor,
        do_stats: bool | torch.Tensor,
        skip_all: bool | torch.Tensor,
        skip_opac: bool | torch.Tensor,
        *,
        height: int,
        width: int,
        sh_degree: int,
        in_place: bool = False,
    ):
        b = w2cs.shape[0]
        stats = model.stats
        grads_sum = model.params.map(torch.zeros_like)
        lds = []
        for i in range(b):
            grads, ld, stats = _view_grads(cfg, render_fn, model, stats, w2cs[i], Ks[i],
                                           images[i], masks[i], do_stats, height, width,
                                           sh_degree, in_place)
            grads_sum = GaussianParams(**{n: getattr(grads_sum, n) + getattr(grads, n)
                                          for n in PARAM_NAMES})
            lds.append(ld)
        grads = grads_sum.map(lambda g: g / float(b))
        ld = {k: torch.stack([d[k] for d in lds]) for k in lds[0]}
        ld = {k: v.max() if k == "isects" else v.mean() for k, v in ld.items()}
        model_new, adam_new = _apply_adam(cfg, model, adam, grads, stats, lr_means,
                                          skip_all, skip_opac, in_place)
        return model_new, adam_new, ld

    return train_step


def make_mesh_train_step(cfg: Config, mesh, render_fn: Callable):
    """The sharded train step of ``mesh`` (``gauss_shard``'s under a gauss
    axis, ``shard``'s otherwise) with the single step's call signature:
    ``height`` is the padded frame's, the state this rank's (its shard under
    ``gauss``). One step closure per frame size, built at its first call.
    On an NCCL mesh ``graphs.GraphedTrainStep(cfg, this step, device,
    mesh=mesh)`` runs it as a CUDA graph per signature."""
    from ..parallel import gauss_shard, shard
    from ..parallel.mesh import GAUSS_AXIS

    steps: Dict[tuple, Callable] = {}

    def train_step(model, adam, w2c, K, image, mask, lr_means, do_stats, skip_all, skip_opac,
                   *, height: int, width: int, sh_degree: int, in_place: bool = False):
        fn = steps.get((height, width))
        if fn is None:
            make = (gauss_shard.make_gauss_sharded_train_step if GAUSS_AXIS in mesh.axis_names
                    else shard.make_sharded_train_step)
            fn = steps[(height, width)] = make(cfg, mesh, render_fn, height, width)
        return fn(model, adam, w2c, K, image, mask, lr_means, do_stats, skip_all, skip_opac,
                  sh_degree=sh_degree, in_place=in_place)

    return train_step


def make_grad_fn(cfg: Config, render_fn: Callable):
    """Pre-Adam gradients of the single-camera step: (grads, absgrad, loss
    dict, radii)."""

    def grad_fn(model, w2c, K, image, mask, *, height, width, sh_degree):
        camera = CameraView(w2c=w2c, K=K, width=width, height=height)
        grads, absgrad, ld, radii, _ = _loss_and_grads(
            cfg, render_fn, model, camera, image, mask, sh_degree
        )
        return grads, absgrad, ld, radii

    return grad_fn


def _dcfg(cfg: Config) -> DensifyConfig:
    return DensifyConfig(
        densify_grad_thresh=cfg.densify_grad_thresh,
        densify_scale_thresh=cfg.densify_scale_thresh,
        num_splits=cfg.num_splits,
        prune_radii_ratio_thresh=cfg.prune_radii_ratio_thresh,
        prune_scale_thresh=cfg.prune_scale_thresh,
        min_opacity=cfg.min_opacity,
    )


# the refine event's counts, in the order of its program's output (after
# the overflow flag)
INFO_KEYS = ("split", "clone", "prune_low_opacity", "prune_large_radii", "prune_large_scale",
             "nbr_gaussians")

def densify_event(dcfg: DensifyConfig, keep_overflow: bool, reduce: Callable | None = None):
    """The refine event as a program over the state's buffers
    (``GraphedTrainStep.replay``): ``fn([noise] + leaves, write)`` runs
    :func:`densify_and_prune` on the buffers with the given split noise,
    returns ``[overflow, *info]`` as int64 (``INFO_KEYS`` order; ``reduce``
    makes them the mesh's: overflow any shard's, info summed) and, after
    every read, writes the event's state into the buffers
    (``graphs.write_back``) where ``write`` holds and the event did not
    overflow, or did at ``keep_overflow`` (the largest capacity, where the
    excess is dropped): on an overflow below it the buffers keep the
    pre-event state, which the host grows and retries on."""

    def event(bufs, write):
        model, adam = state_from(bufs[1:])
        new_model, new_adam, info, overflow = densify_and_prune(model, adam, None, dcfg,
                                                                noise=bufs[0])
        vals = torch.stack([overflow.to(torch.int64)] + [info[k].to(torch.int64)
                                                         for k in INFO_KEYS])
        if reduce is not None:
            vals = reduce(vals)
        k = len(PARAM_NAMES)  # the step counts, which an event leaves
        write_back(write & ((vals[0] == 0) | keep_overflow), state_leaves(model, adam)[:-k],
                   state_leaves(new_model, new_adam)[:-k])
        return vals

    return event


def reset_event(min_opacity: float):
    """The opacity reset as a program over the state's buffers
    (``GraphedTrainStep.replay``; the counterpart of JAX's
    ``donate_argnums=(0, 1)``): :func:`reset_opacities` on the buffers, its
    opacities and the opacity group's Adam moments written in place."""

    def event(bufs, write):
        model, adam = state_from(bufs)
        new_model, new_adam = reset_opacities(model, adam, min_opacity)
        name = "logit_opacities"
        write_back(write, [getattr(t, name) for t in (model.params, adam.mu, adam.nu)],
                   [getattr(t, name) for t in (new_model.params, new_adam.mu, new_adam.nu)])

    return event


def event_values(info: Dict[str, torch.Tensor], overflow: torch.Tensor):
    """A refine event's overflow flag and counts on the host, read with one
    copy."""
    vals = torch.stack([overflow.reshape(()).to(torch.int64)]
                       + [info[k].reshape(()).to(torch.int64) for k in INFO_KEYS]).tolist()
    return bool(vals[0]), dict(zip(INFO_KEYS, vals[1:]))


def make_densify_step(cfg: Config, graphed: GraphedTrainStep | None = None):
    """``densify_step(model, adam, generator) -> (model, adam, info,
    overflow)``: :func:`densify_and_prune` run eagerly, or with ``graphed``
    (the run's graphed step) a program over its state, one per capacity
    (:func:`densify_event`): the split noise drawn eagerly from
    ``generator`` into the program's input buffer (the graph holds no
    generator state, so a retry restores the generator as the eager event
    does), the returned state the step's buffers."""
    dcfg = _dcfg(cfg)
    if graphed is None:
        def densify_step(model, adam, generator):
            return densify_and_prune(model, adam, generator, dcfg)

        return densify_step

    def densify_step(model, adam, generator):
        model, adam = graphed.own(model, adam)
        cap = model.capacity
        noise = torch.randn((cap, 3), generator=generator, dtype=torch.float32,
                            device=model.alive.device)
        keep = cap >= cfg.max_capacity
        vals = graphed.replay(("densify", cap, keep), densify_event(dcfg, keep), [noise]).out
        model, adam = state_from(graphed.state)
        return model, adam, dict(zip(INFO_KEYS, vals[1:].unbind())), vals[0] > 0

    return densify_step


def make_reset_step(cfg: Config, graphed: GraphedTrainStep | None = None):
    """``reset_step(model, adam) -> (model, adam)``: :func:`reset_opacities`
    run eagerly, or with ``graphed`` a program over its state that rewrites
    the opacities and their Adam moments in place (:func:`reset_event`)."""
    if graphed is None:
        return lambda model, adam: reset_opacities(model, adam, cfg.min_opacity)

    def reset_step(model, adam):
        model, adam = graphed.own(model, adam)
        graphed.replay(("reset", model.capacity), reset_event(cfg.min_opacity))
        return state_from(graphed.state)

    return reset_step


def counted_isects(graphed: GraphedTrainStep, counter: Callable, cfg: Config, w2c, K, *,
                   height: int, width: int, mesh=None) -> torch.Tensor:
    """``counter`` (``make_isect_counter``'s, or under ``mesh``
    ``make_striped_isect_counter``'s, built with ``cfg``'s binning knobs) as
    a program over ``graphed``'s state, keyed on the capacity, the frame
    size and those knobs (and the mesh's stripe partition and interleave);
    under a gauss axis the shards are gathered inside it. Returns its counts
    (the program's output: read them before the next replay)."""
    where = () if mesh is None else (cfg.stripe_partition, cfg.stripe_interleave)
    key = ("isects", graphed.state[0].shape[0], height, width, cfg.tile_size, cfg.max_tiles,
           cfg.ov_frac, cfg.small_budget) + where
    gather = None
    if mesh is not None:
        from ..parallel.mesh import GAUSS_AXIS

        if GAUSS_AXIS in mesh.axis_names:
            from ..parallel.gauss_shard import gather_state

            gather = functools.partial(gather_state, mesh=mesh)

    def count(bufs, write):
        model = state_from(bufs[2:])[0]
        if gather is not None:
            model = gather(model)
        return counter(model.params, model.alive, bufs[0], bufs[1], height=height, width=width)

    return graphed.replay(key, count, [w2c, K]).out


@dataclasses.dataclass
class TrainLoopState:
    """Host-side mutable training context."""

    model: GaussianModelState
    adam: AdamState
    active_sh_degree: int
    step: int = 0


def run_densify_with_growth(
    loop: TrainLoopState,
    densify_step,
    generator: torch.Generator,
    cfg: Config,
    grow: Callable = grow_state,
) -> Dict[str, int]:
    """Run a densify event; on free-slot overflow, grow capacity (x2) and
    retry on the pre-event state with the same split noise. The overflow
    flag and the counts come to the host in one copy. ``grow(model, adam,
    capacity)`` grows a state (``GraphedTrainStep.grown`` grows into
    buffers prepared ahead)."""
    gen_state = generator.get_state()
    while True:
        generator.set_state(gen_state)
        new_model, new_adam, info, overflow = densify_step(loop.model, loop.adam, generator)
        overflow, info = event_values(info, overflow)
        if not overflow:
            n = info["nbr_gaussians"]
            cap = loop.model.capacity
            # pre-emptive growth: keep >= 15% headroom for the next event
            if n > 0.85 * cap and cap < cfg.max_capacity:
                new_cap = min(cap * 2, cfg.max_capacity)
                logger.info(f"growing capacity {cap} -> {new_cap} ({n} gaussians alive)")
                loop.model, loop.adam = grow(new_model, new_adam, new_cap)
            else:
                # compact only when the 1.3x-headroom target is at most
                # half the capacity (a softer threshold oscillates between
                # growing and compacting, as in the JAX package)
                want = _round_up_capacity(int(n * 1.3)) if cfg.shrink_capacity else cap
                if want * 2 <= cap:
                    logger.info(f"compacting capacity {cap} -> {want} ({n} gaussians alive)")
                    loop.model, perm = compact_capacity(new_model, want)
                    loop.adam = permute_adam_state(new_adam, perm)
                else:
                    loop.model, loop.adam = new_model, new_adam
            return info
        cap = loop.model.capacity
        if cap >= cfg.max_capacity:
            logger.warning(f"densify overflow at max capacity {cap}; dropping excess")
            loop.model, loop.adam = new_model, new_adam
            return info
        new_cap = min(cap * 2, cfg.max_capacity)
        logger.info(f"densify overflow: growing capacity {cap} -> {new_cap}")
        loop.model, loop.adam = grow(loop.model, loop.adam, new_cap)


def run_sharded_densify_with_growth(
    loop: TrainLoopState,
    sharded_densify_step,
    generator: torch.Generator,
    cfg: Config,
    mesh,
) -> Dict[str, int]:
    """A densify event over Gaussian-sharded state (``loop`` holds this
    rank's shard). On any shard's free-slot overflow, grow the capacity per
    shard (``grow_state_sharded``, aligned to the shard count) and retry on
    the pre-event state with the same noise. Capacity compaction is skipped
    (it would need a global permutation), as in the JAX trainer. The info
    and overflow are summed over the shards, so every rank decides alike,
    and come to the host in one copy."""
    from ..parallel.gauss_shard import grow_state_sharded
    from ..parallel.mesh import GAUSS_AXIS

    n_shards = mesh.axis_size(GAUSS_AXIS)

    def aligned(cap: int) -> int:
        return cap - cap % n_shards

    # one draw of the shared generator an event: the shards' seeds
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    while True:
        new_model, new_adam, info, overflow = sharded_densify_step(loop.model, loop.adam, seed)
        overflow, info = event_values(info, overflow)
        cap = loop.model.capacity * n_shards
        new_cap = aligned(min(cap * 2, cfg.max_capacity))
        if not overflow:
            n = info["nbr_gaussians"]
            if n > 0.85 * cap and new_cap > cap:
                logger.info(f"growing capacity {cap} -> {new_cap} ({n} gaussians alive, "
                         f"{n_shards} shards)")
                loop.model, loop.adam = grow_state_sharded(new_model, new_adam, new_cap, mesh)
            else:
                loop.model, loop.adam = new_model, new_adam
            return info
        if new_cap <= cap:
            logger.warning(f"densify overflow at max capacity {cap}; dropping excess")
            loop.model, loop.adam = new_model, new_adam
            return info
        logger.info(f"densify overflow: growing capacity {cap} -> {new_cap} ({n_shards} shards)")
        loop.model, loop.adam = grow_state_sharded(loop.model, loop.adam, new_cap, mesh)


class _PendingScalars:
    """A step's loss dict copied to the host without waiting: the copy goes
    into pinned memory behind an event, and is read once the event has
    passed (a few steps later)."""

    def __init__(self, ld: Dict[str, torch.Tensor]):
        self.keys = list(ld)
        vals = torch.stack([ld[k].to(torch.float32) for k in self.keys])
        self.event = None
        if vals.is_cuda:
            self.host = torch.empty(vals.shape, dtype=torch.float32, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def get(self) -> Dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.keys, self.host.tolist()))


def _frame_tensors(data: Dict[str, Any], device, keys=("w2c", "K", "image", "mask")):
    """The frame dict's arrays (numpy, or tensors from the frame cache) as
    f32 tensors on ``device``."""
    return [torch.as_tensor(data[k], dtype=torch.float32, device=device) for k in keys]


def train(
    cfg: Config, scene=None, resume_from: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> TrainLoopState:
    """Full training run, on one device or, with ``cfg.mesh_shape``, as one
    rank of a mesh (see the module docstring). ``scene`` is a ``Scene`` or any
    object with its interface (``pc.xyzs``, ``pc.rgbs``, ``pc.nbr_points``,
    ``nbr_data(split)``, ``get_data(split, i)``; for the frame cache also
    ``frames``, ``train_indexes`` and ``eval_indexes``); None builds the
    ``Scene`` from ``cfg.data``. Returns the final loop state (also
    checkpointed at ``save_model_iterations`` when ``output`` is set).
    ``resume_from``: a checkpoint path; with optimizer state the run
    continues exactly, without it Adam restarts."""
    from ..evaluation.evaluator import Evaluator
    from ..scene.scene import Scene, prefetch_frames
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.tb import create_tb_writer, tb_report

    dev = resolve_device(device)
    # optional mesh: "tiles:N" (stripes sharded, parameters replicated),
    # "gauss:N" (ZeRO: parameters, moments and statistics sharded, stripes
    # too), "gauss:G,tiles:T" (storage over G, stripes over G*T)
    mesh = None
    gauss = False
    rank0 = True
    if cfg.mesh_shape:
        from ..parallel import gauss_shard, shard
        from ..parallel.mesh import GAUSS_AXIS, mesh_from_shape

        mesh = mesh_from_shape(cfg.mesh_shape, dev)
        gauss = GAUSS_AXIS in mesh.axis_names
        rank0 = dist.get_rank() == 0
        if not rank0:  # rank 0 alone logs (a rank's process is its own)
            logging.getLogger(__name__.split(".")[0]).setLevel(logging.ERROR)
        logger.info(f"training on a {mesh.size}-device mesh "
                 f"{dict(zip(mesh.axis_names, mesh.shape))}, {mesh.backend}")
    n_gauss = mesh.axis_size(GAUSS_AXIS) if gauss else 1

    def full_state(state):
        """The whole model or Adam state (under ``gauss`` every rank must call)."""
        return gauss_shard.gather_state(state, mesh) if gauss else state

    if scene is None:
        scene = Scene.from_config(cfg, cfg.output if rank0 else None)

    if resume_from is not None:
        model, sh_deg, start_step, adam = load_checkpoint(Path(resume_from), dev)
        if adam is None:
            logger.warning(
                f"checkpoint {resume_from} has no optimizer state: resuming "
                "with fresh Adam moments (a warm start, not an exact continuation)"
            )
            adam = init_adam_state(model.params)
        alive = model.num_alive()
        logger.info(f"resumed from {resume_from} at step {start_step} ({alive} gaussians)")
        loop = TrainLoopState(model=model, adam=adam, active_sh_degree=sh_deg, step=start_step)
    else:
        capacity = cfg.initial_capacity if cfg.initial_capacity > 0 else None
        model = init_gaussian_state(
            scene.pc.xyzs, scene.pc.rgbs, cfg.sh_degree, capacity=capacity, device=dev
        )
        alive = scene.pc.nbr_points
        logger.info(f"initialized {alive} gaussians (capacity {model.capacity})")
        loop = TrainLoopState(
            model=model,
            adam=init_adam_state(model.params),
            active_sh_degree=0 if cfg.sh_degree_interval != 0 else cfg.sh_degree,
        )
    if gauss:
        loop.model = gauss_shard.shard_state(loop.model, mesh)
        loop.adam = gauss_shard.shard_state(loop.adam, mesh)

    def capacity_now() -> int:
        return loop.model.capacity * n_gauss

    render_fn = get_render_fn(cfg)
    # on the card the step is a CUDA graph per signature (graphs.py), under
    # an NCCL mesh too; on the CPU, and under a gloo mesh, whose collectives
    # wait on the host and cannot be captured, it runs eagerly
    eager_why = []
    if dev.type != "cuda":
        eager_why.append(f"{dev} is not a CUDA device (a CUDA graph runs on one only)")
    if mesh is not None and mesh.backend != "nccl":
        eager_why.append(f"the mesh's {mesh.backend} collectives wait on the host and cannot be "
                         "captured in a CUDA graph (NCCL's can)")
    graphed = not eager_why
    if eager_why:
        logger.info("the train step runs eagerly: " + "; ".join(eager_why))
    train_step = None

    def new_train_step() -> None:
        """The step over the current ``render_fn`` (after a binning retune);
        a graphed step keeps the state's buffers and drops its programs."""
        nonlocal train_step
        step = (make_train_step(cfg, render_fn) if mesh is None
                else make_mesh_train_step(cfg, mesh, render_fn))
        if not graphed:
            train_step = step
        elif train_step is None:
            train_step = GraphedTrainStep(cfg, step, dev, mesh=mesh)
        else:
            train_step.use(step)

    new_train_step()
    # the refine event, the opacity reset and the counters: programs over
    # the graphed step's state (its buffers by reference), or eager
    refine = train_step if graphed else None

    # intersection-capacity watchdog for the tiled renderer: if the binned
    # count nears isect_mult * capacity, deep tiles would be truncated
    # (and the step's gradient zeroed), so the multiplier grows
    isect_counter = None
    overflow_steps = 0  # steps whose gradient was zeroed by isect overflow
    if cfg.renderer == "tiled":
        from ..ops.rasterize_tiled import _ov_capacity, make_isect_counter, max_isect_cap

        def _make_counter():
            if mesh is not None:
                # each rank bins its stripe; the counts are the fullest
                # rank's, the same on every rank
                return shard.make_striped_isect_counter(
                    mesh, cfg.tile_size, cfg.max_tiles, cfg.max_tiles,
                    ov_frac=cfg.ov_frac, small_budget=cfg.small_budget,
                    interleave=cfg.stripe_interleave, partition=cfg.stripe_partition,
                )
            return make_isect_counter(
                cfg.tile_size, cfg.max_tiles, cfg.max_tiles,
                ov_frac=cfg.ov_frac, small_budget=cfg.small_budget,
            )

        isect_counter = _make_counter()

    def count_isects(data):
        w2c, K = _frame_tensors(data, dev, ("w2c", "K"))
        height, width = data["height"], data["width"]
        if refine is None:
            model = full_state(loop.model)
            vals = isect_counter(model.params, model.alive, w2c, K, height=height, width=width)
            return vals.cpu().numpy()
        loop.model, loop.adam = refine.own(loop.model, loop.adam)
        return counted_isects(refine, isect_counter, cfg, w2c, K, height=height, width=width,
                              mesh=mesh).cpu().numpy()

    def autotune_isect_mult(data):
        """Size the intersection capacity from the first frame's count (it
        drives the per-row costs); the watchdog grows it if later frames
        need more. Also picks the small-population budget and overflow
        fraction with the smallest binning sort domain."""
        nonlocal render_fn, isect_counter
        if isect_counter is None:
            return
        vals = count_isects(data)
        n, n_ov = int(vals[0]), int(vals[1])
        want, want_b, want_ov = tuned_binning(cfg, vals, capacity_now(), 1.2)
        if want != cfg.isect_mult or want_ov != cfg.ov_frac or want_b != cfg.small_budget:
            logger.info(
                f"isect autotune: {n} intersections / {n_ov} overflow on the first "
                f"frame -> isect_mult {cfg.isect_mult} -> {want}, ov_frac "
                f"{cfg.ov_frac} -> {want_ov}, small_budget {cfg.small_budget} -> {want_b}"
            )
            cfg.isect_mult = want
            cfg.ov_frac = want_ov
            cfg.small_budget = want_b
            render_fn = get_render_fn(cfg)
            new_train_step()
            isect_counter = _make_counter()
            evaluator.invalidate(render_fn)

    def maybe_grow_isect_mult(n: int, at_step: int) -> None:
        """Grow the intersection capacity when the binned count nears it.
        Fed from the train step's own binning (the 'isects' loss-dict
        channel) and once per densify event, right after the population
        jump (the JAX package counts just before the event)."""
        nonlocal render_fn, overflow_steps
        cap = cfg.isect_mult * capacity_now()
        if n > cap:
            overflow_steps += 1
            logger.warning(
                f"step {at_step}: {n} intersections exceeded capacity {cap:.0f}: "
                f"that step's gradient was zeroed ({overflow_steps} overflow steps total)"
            )
            if tb_writer is not None:
                tb_report(tb_writer, at_step, {"train/overflow_steps": overflow_steps})
        if n > 0.9 * cap:
            max_mult = max_isect_cap(cfg.isect_hbm_budget_mb) / max(capacity_now(), 1)
            want_mult = math.floor(min(cfg.isect_mult * 2, max_mult) * 1e3) / 1e3
            if want_mult <= cfg.isect_mult:
                logger.warning(
                    f"intersections {n} near capacity {cap:.0f} but isect_mult "
                    f"{cfg.isect_mult} is at the memory budget "
                    f"({cfg.isect_hbm_budget_mb} MB): not growing"
                )
                return
            cfg.isect_mult = want_mult
            logger.info(f"intersections {n} near capacity {cap:.0f}: raising isect_mult to {cfg.isect_mult}")
            render_fn = get_render_fn(cfg)
            new_train_step()
            evaluator.invalidate(render_fn)

    def check_isect_capacity(data):
        nonlocal render_fn, isect_counter, autotuned
        if isect_counter is None:
            return
        vals = count_isects(data)
        n, n_ov = int(vals[0]), int(vals[1])
        # re-tighten an oversized capacity (the startup autotune saw the
        # initial population); 2x hysteresis against the 1.2x target
        want_tight = max(0.25, n * 1.2 / max(capacity_now(), 1))
        if cfg.isect_mult > 2.0 * want_tight:
            logger.info(
                f"isect_mult {cfg.isect_mult} oversized for {n} intersections at "
                f"capacity {capacity_now()}: re-running the binning autotune"
            )
            autotuned = False  # the main loop re-runs autotune_isect_mult
            return
        ov_cap = _ov_capacity(capacity_now(), cfg.ov_frac)
        if n_ov > 0.85 * ov_cap:
            cfg.ov_frac = round(min(1.0, cfg.ov_frac * 2.0), 3)
            logger.info(f"{n_ov} overflow gaussians near capacity {ov_cap}: raising ov_frac to {cfg.ov_frac}")
            render_fn = get_render_fn(cfg)
            new_train_step()
            isect_counter = _make_counter()
            evaluator.invalidate(render_fn)
        maybe_grow_isect_mult(n, loop.step)

    densify_step = make_densify_step(cfg, refine)
    reset_step = make_reset_step(cfg, refine)
    grow = train_step.grown if graphed else grow_state
    if gauss:
        sharded_densify_step = gauss_shard.make_sharded_densify_step(
            _dcfg(cfg), mesh, refine, cfg.max_capacity)
    means_lr = log_lerp_schedule(
        cfg.means_lr_init, cfg.means_lr_final, cfg.means_lr_schedule_max_steps
    )
    # graphed, the eval's programs join the step's (one pool) and read the
    # model they are given by reference: no copy of the model is kept
    evaluator = Evaluator(cfg.eval_render_num, render_fn,
                          programs=train_step.programs if graphed else None)
    generator = torch.Generator(device=dev).manual_seed(cfg.random_seed)
    # the capture ahead of need: capacity growths and SH-degree bumps give
    # the graphed step a new signature; capture the next program before its
    # first step (without a mesh, as the JAX trainer's precompiler)
    precompiler = None
    if graphed and mesh is None:
        from .precompile import StepPrecompiler

        precompiler = StepPrecompiler(train_step)

    tb_writer = None
    if cfg.output is not None and rank0:
        tb_path = Path(cfg.output) / "tensorboard"
        logger.info(f"monitor training status: tensorboard --logdir {tb_path}")
        tb_writer = create_tb_writer(str(tb_path))

    viewer = None
    # the viewer reads .model and .active_sh_degree: the loop's, or under
    # gauss a gathered copy refreshed every iteration
    view_src = None
    if cfg.view_online and cfg.output is not None:
        view_src = dataclasses.replace(loop, model=full_state(loop.model)) if gauss else loop
    if cfg.view_online and cfg.output is not None and rank0:
        from ..viewer.integration import construct_training_viewer

        viewer = construct_training_viewer(view_src, cfg, Path(cfg.output))

    save_iters = set(cfg.save_model_iterations)
    background = _background(cfg, dev)

    # device-resident frames: one upload at start, each step's frame an
    # index on the card (streaming when a split does not fit the budget);
    # the eval split unpadded, as the JAX trainer keeps it
    frame_cache = eval_cache = None
    # under a mesh, frames are padded to a multiple of the stripe count (pad
    # rows masked out); the eval split, rendered whole on rank 0, is not
    pad_unit = 1 if mesh is None else mesh.size * max(1, cfg.stripe_interleave)
    if cfg.data_device_cache:
        from ..scene.device_cache import build_cache

        workers = max(1, cfg.dataloader_workers)
        frame_cache = build_cache(scene, "train", cfg.data_device_cache_mb,
                                  num_workers=workers, pad_rows_to=pad_unit, device=dev)
        if scene.nbr_data("eval") > 0 and frame_cache is not None and rank0:
            eval_cache = build_cache(scene, "eval", cfg.data_device_cache_mb,
                                     num_workers=workers, device=dev)

    t_start = time.time()
    last_loss = float("nan")
    autotuned = False
    profiler = None  # the profile_steps window, steps 10 .. 10 + profile_steps
    # delayed loss readback: sampled steps' scalars are read three samples
    # later, so the host never waits for the card inside the loop
    pending_losses: list = []

    def _drain_losses(min_pending: int) -> None:
        nonlocal last_loss
        while len(pending_losses) > min_pending:
            old_step, old = pending_losses.pop(0)
            losses = old.get()
            n_isects = losses.pop("isects", None)
            last_loss = losses["total"]
            if tb_writer is not None:
                tb_report(tb_writer, old_step, {"train/loss": losses})
            if n_isects is not None:
                if tb_writer is not None:
                    tb_report(tb_writer, old_step, {"train/num_isects": n_isects})
                maybe_grow_isect_mult(int(n_isects), old_step)

    # wall-time buckets of the host loop (EGS_TORCH_LOOP_TIMING=1 logs them
    # every 100 steps, per step): the JAX trainer's EGS_TPU_LOOP_TIMING
    loop_timing = os.environ.get("EGS_TORCH_LOOP_TIMING") == "1"
    buckets: Dict[str, float] = collections.defaultdict(float)
    t_prev = time.perf_counter()

    def _bucket(name: str) -> None:
        nonlocal t_prev
        if loop_timing:
            now = time.perf_counter()
            buckets[name] += now - t_prev
            t_prev = now

    if frame_cache is not None:  # the same order as streaming's shuffle
        shuffled = list(range(scene.nbr_data("train")))
        random.shuffle(shuffled)
        data_iter = (frame_cache.get(i) for i in shuffled)
    else:
        data_iter = prefetch_frames(scene, "train", shuffle=True, num_workers=cfg.dataloader_workers)
    for data in data_iter:
        _bucket("data")
        if loop.step >= cfg.total_iterations:
            # resumed runs start mid-schedule; the index tiling still spans
            # the full budget
            break
        loop.step += 1
        step = loop.step
        all_tb_info: Dict[str, Any] = {}

        if not autotuned:
            autotune_isect_mult(data)
            autotuned = True

        if cfg.profile_steps > 0 and cfg.output is not None and rank0:
            if step == 10 and profiler is None:
                from ..utils.profiling import Trace

                profiler = Trace(Path(cfg.output) / "profile")
                profiler.start()
            elif profiler is not None and step == 10 + cfg.profile_steps:
                profiler.stop()
                profiler = None

        in_refine = cfg.refine_start < step <= cfg.refine_stop
        densify_now = in_refine and (step - cfg.refine_start) % cfg.refine_every == 0
        reset_now = in_refine and (step - cfg.refine_start) % cfg.reset_opacities_every == 0

        w2c, K, image, mask = _frame_tensors(data, dev)
        height = data["height"]
        if mesh is not None:
            if step == 1:
                _check_same_frame(w2c, mesh)
            image, mask = _pad_rows(image, mask, pad_unit)
            height = image.shape[0]
        loop.model, loop.adam, ld = train_step(
            loop.model, loop.adam, w2c, K, image, mask,
            means_lr(step), in_refine, densify_now, reset_now,
            height=height, width=data["width"], sh_degree=loop.active_sh_degree,
        )
        _bucket("dispatch")

        log_now = (
            step == 1
            or step % cfg.log_every == 0
            or step % cfg.eval_every == 0
            or densify_now
        )
        if log_now or step % 10 == 0:
            pending_losses.append((step, _PendingScalars(ld)))
            _drain_losses(min_pending=3)
        _bucket("loss_sync")

        if step in save_iters and cfg.output is not None:
            model = full_state(loop.model)
            adam = full_state(loop.adam) if cfg.save_optimizer_state else None
            if rank0:
                save_checkpoint(
                    Path(cfg.output) / "checkpoints" / f"iterations_{step}.npz",
                    model, loop.active_sh_degree, step, adam=adam,
                )
            del model, adam
        _bucket("ckpt")

        if scene.nbr_data("eval") > 0 and (step == 1 or step % cfg.eval_every == 0):
            # full single-device frames of the whole model, on rank 0
            model = full_state(loop.model)
            if rank0:
                metrics = evaluator.evaluate(
                    scene, "eval", model, loop.active_sh_degree, background,
                    num_workers=cfg.dataloader_workers, cache=eval_cache,
                )
                for k, v in metrics.items():
                    if "render" in k:
                        all_tb_info[f"render/{k}"] = v
                    elif k in ("psnr", "ssim", "lpips", "lpips_proxy", "fps", "latency_ms",
                               "latency_device_ms"):
                        all_tb_info[f"eval/{k}"] = v
                logger.info("eval @ step %d: %s", step, ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float)))
            del model
            if mesh is not None:
                dist.barrier()
        _bucket("eval")

        if densify_now:
            if gauss:
                info = run_sharded_densify_with_growth(loop, sharded_densify_step, generator,
                                                       cfg, mesh)
            else:
                info = run_densify_with_growth(loop, densify_step, generator, cfg, grow)
            # on the grown population, so the next step's capacity covers it
            check_isect_capacity(data)
            if precompiler is not None:
                # the next doubling (grown at 0.85 of the capacity; named
                # from 0.55), with the next SH degree when its bump may come
                # first, captured once the growth is near; a prepared
                # capacity the rule no longer names goes
                targets = growth_targets(cfg, info["nbr_gaussians"], loop.model.capacity,
                                         loop.active_sh_degree)
                precompiler.settle({c for c, _ in targets})
                if growth_near(alive, info["nbr_gaussians"], loop.model.capacity):
                    for cap_t, sh_t in targets:
                        precompiler.warm(cfg, loop.model, loop.adam, data["height"],
                                         data["width"], sh_t, cap_t, frame=(w2c, K, image, mask))
            alive = info["nbr_gaussians"]
            all_tb_info["train/densify"] = {"split": info["split"], "clone": info["clone"]}
            all_tb_info["train/prune"] = {
                "low_opacity": info["prune_low_opacity"],
                "large_radii": info["prune_large_radii"],
                "large_scale": info["prune_large_scale"],
            }
            all_tb_info["train/nbr_gaussians"] = info["nbr_gaussians"]
        _bucket("densify")
        if reset_now:
            loop.model, loop.adam = reset_step(loop.model, loop.adam)

        if precompiler is not None and sh_bump_due(cfg, step, loop.active_sh_degree):
            precompiler.warm(cfg, loop.model, loop.adam, data["height"], data["width"],
                             loop.active_sh_degree + 1, loop.model.capacity,
                             frame=(w2c, K, image, mask))
        if cfg.sh_degree_interval != 0 and step % cfg.sh_degree_interval == 0:
            loop.active_sh_degree = min(loop.active_sh_degree + 1, cfg.sh_degree)

        if tb_writer is not None and log_now:
            tb_report(tb_writer, step, all_tb_info)

        _bucket("other")
        if step % 100 == 0:
            elapsed = time.time() - t_start
            logger.info(
                f"step {step}/{cfg.total_iterations} loss={last_loss:.5f} "
                f"({step / elapsed:.2f} it/s)"
            )
            if loop_timing and buckets:
                total = sum(buckets.values())
                parts = " ".join(f"{k}={v * 1e3 / 100:.1f}ms" for k, v in
                                 sorted(buckets.items(), key=lambda kv: -kv[1]))
                logger.info(f"loop timing (per step over last 100): {parts} "
                            f"total={total * 1e3 / 100:.1f}ms")
                buckets.clear()

        if view_src is not None:
            view_src.active_sh_degree = loop.active_sh_degree
            if gauss:
                view_src.model = full_state(loop.model)
        if viewer is not None:
            viewer.update_render_image()

    _drain_losses(min_pending=0)
    if precompiler is not None:
        precompiler.shutdown()
    if graphed:
        train_step.reset()  # the returned state is its buffers, which stay
    if profiler is not None:  # the run ended inside the window
        profiler.stop()
    if tb_writer is not None:
        tb_writer.close()
    if viewer is not None:
        viewer.stop()
    if gauss:  # every rank returns the whole state
        loop.model, loop.adam = full_state(loop.model), full_state(loop.adam)
    return loop


def _pad_rows(image: torch.Tensor, mask: torch.Tensor, unit: int):
    """Pad a frame's rows up to a multiple of ``unit`` (image rows 0, mask
    rows 1, which the loss ignores); cached frames arrive padded."""
    pad = -image.shape[0] % unit
    if pad:
        image = torch.cat([image, image.new_zeros((pad,) + tuple(image.shape[1:]))])
        mask = torch.cat([mask, mask.new_ones((pad,) + tuple(mask.shape[1:]))])
    return image, mask


def _check_same_frame(w2c: torch.Tensor, mesh) -> None:
    """Every rank must train on the same frame each step: a rank seeded
    otherwise draws another frame order and would render its stripe of
    another camera."""
    from ..parallel import collectives as col

    hi = col.all_reduce(w2c, mesh.world, "max")
    if not torch.equal(hi, -col.all_reduce(-w2c, mesh.world, "max")):
        raise RuntimeError(
            "the ranks drew different frames: seed every rank alike (random, numpy)"
        )
