"""Gaussian-sharded training (ZeRO-style) combined with image-stripe
sharding; counterpart of ``easy_gaussian_splatting_tpu/parallel/gauss_shard.py``.

- Each rank stores 1/G of every per-Gaussian tensor (parameters, Adam
  moments, densify statistics): gauss index g holds rows ``[g*C/G,
  (g+1)*C/G)`` of the capacity-C buffers. On a ``(gauss, tiles)`` mesh the
  ranks of one gauss index hold the same shard.
- For compute the population is all-gathered over the gauss group, every
  rank renders its own stripe (``shard.py``), the gradients are summed over
  the tiles group and reduce-scattered over the gauss group, so each rank
  updates only its shard: one all-gather and one reduce-scatter a step.
- Densification runs shard by shard (``make_sharded_densify_step``): clones
  and splits fill free slots of their parent's own shard, info counts are
  summed and the overflow flag is any shard's, so every rank takes the same
  growth decision. Nothing is gathered for it.

The functions take and return a rank's shard; ``gather_state`` rebuilds
the full state on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.density import densify_and_prune
from ..models.gaussians import PARAM_NAMES, GaussianModelState, GaussianParams, grow_capacity
from ..models.optimizer import AdamState, grow_adam_state
from ..training.config import Config
from ..training.graphs import state_from
from ..training.trainer import (
    INFO_KEYS,
    _apply_adam,
    densify_event,
    grad_leaves,
    param_grads,
    update_stats,
)
from . import collectives as col
from .mesh import GAUSS_AXIS, TILE_AXIS
from .shard import (
    _check_height,
    _partition,
    adaptive_row_bounds,
    effective_interleave,
    reduce_losses,
    stripe_loss,
)


def _gauss(mesh):
    """(gauss group, its size, this rank's gauss index, tiles group or None)."""
    tiles = mesh.group(TILE_AXIS) if TILE_AXIS in mesh.axis_names else None
    return (mesh.group(GAUSS_AXIS), mesh.axis_size(GAUSS_AXIS), mesh.axis_index(GAUSS_AXIS),
            tiles)


def _rows(state) -> list:
    """The per-Gaussian tensors of a model state or an Adam state."""
    if isinstance(state, GaussianModelState):
        s = state.stats
        return ([getattr(state.params, n) for n in PARAM_NAMES]
                + [state.alive, s.grad_norm_accum, s.collecting_counts, s.max_radii])
    return [getattr(state.mu, n) for n in PARAM_NAMES] + [getattr(state.nu, n) for n in PARAM_NAMES]


def _with_rows(state, rows):
    """``state`` with its per-Gaussian tensors replaced by ``rows``."""
    k = len(PARAM_NAMES)
    if isinstance(state, GaussianModelState):
        stats = type(state.stats)(grad_norm_accum=rows[k + 1], collecting_counts=rows[k + 2],
                                  max_radii=rows[k + 3])
        return GaussianModelState(params=GaussianParams(**dict(zip(PARAM_NAMES, rows[:k]))),
                                  alive=rows[k], stats=stats)
    return AdamState(mu=GaussianParams(**dict(zip(PARAM_NAMES, rows[:k]))),
                     nu=GaussianParams(**dict(zip(PARAM_NAMES, rows[k:]))), steps=state.steps)


def shard_state(state, mesh):
    """This rank's shard of a full model or Adam state (rows of its gauss
    index; the Adam step counts are replicated)."""
    _, n, g, _ = _gauss(mesh)
    rows = _rows(state)
    cap = rows[0].shape[0]
    if cap % n:
        raise ValueError(f"capacity {cap} must be divisible by the gauss mesh size {n}")
    k = cap // n
    return _with_rows(state, [x[g * k:(g + 1) * k].clone() for x in rows])


def gather_state(state, mesh):
    """The full model or Adam state from every rank's shard (one all-gather
    over the gauss group; every rank of it must call)."""
    group = _gauss(mesh)[0]
    rows = _rows(state)
    return _with_rows(state, col.unpack_rows(col.all_gather_rows(col.pack_rows(rows), group), rows))


def build_gauss_grads(cfg: Config, mesh, render_fn: Callable, height: int, width: int):
    """The ZeRO gradient exchange shared by the train step and
    ``make_gauss_sharded_grad_fn``: all-gather the population, render and
    differentiate this rank's stripe, sum over the tiles group,
    reduce-scatter over the gauss group. Returns ``fn(params_shard,
    alive_shard, w2c, K, image, mask, sh_degree) -> (grads_shard,
    absgrad_shard, loss dict, radii_full, radii_shard)``.

    The stripe index is ``gauss_idx * n_tiles + tile_idx`` (the rank), the
    order of the image gather over the whole mesh. JAX divides the
    reduce-scattered sum by the mesh size because its gather's transpose
    multiplies each stripe's gradient by it; here each rank's gradient is
    its stripe's alone (``collectives``), so the sum needs no division."""
    n_total = mesh.size
    group_g, n_gauss, g_idx, group_t = _gauss(mesh)
    _check_height(height, n_total)
    k_slabs = effective_interleave(height, n_total, cfg.stripe_interleave)
    adaptive = _partition(cfg) == "adaptive"
    world, idx = mesh.world, mesh.stripe_index

    def per_rank(params_shard, alive_shard, w2c, K, image, mask, sh_degree):
        like = [getattr(params_shard, n) for n in PARAM_NAMES] + [alive_shard]
        full = col.unpack_rows(col.all_gather_rows(col.pack_rows(like), group_g), like)
        params = GaussianParams(**dict(zip(PARAM_NAMES, full[:-1])))
        alive = full[-1]
        cap = alive.shape[0]
        shard = cap // n_gauss
        bounds = (adaptive_row_bounds(params, alive, w2c, K, height, n_total)
                  if adaptive else None)
        leaves, absd = grad_leaves(params, cap)
        ld, radii, nis = stripe_loss(cfg, render_fn, leaves, alive, absd, w2c, K, image, mask,
                                     sh_degree, height, width, n_total, idx, k_slabs, bounds, world)
        grads = param_grads(ld["total"], leaves, absd)
        buf = col.pack_rows(grads)
        if group_t is not None:
            buf = col.all_reduce(buf, group_t)
        grads = col.unpack_rows(col.reduce_scatter_rows(buf, group_g), grads)
        radii_full = col.all_reduce(radii.detach(), world, "max")
        return (
            GaussianParams(**dict(zip(PARAM_NAMES, grads[:-1]))),
            grads[-1],
            reduce_losses(ld, nis, world),
            radii_full,
            radii_full[g_idx * shard:(g_idx + 1) * shard],
        )

    return per_rank


def make_gauss_sharded_grad_fn(cfg: Config, mesh, render_fn: Callable, height: int, width: int):
    """Pre-Adam gradients of the gauss-sharded step, gathered back to full
    arrays, for gradient-level equivalence tests: ``grad_fn(model_shard,
    w2c, K, image, mask, *, sh_degree) -> (grads, absgrad, loss dict,
    radii)``."""
    grads_impl = build_gauss_grads(cfg, mesh, render_fn, height, width)
    group_g = _gauss(mesh)[0]

    def grad_fn(model, w2c, K, image, mask, *, sh_degree):
        grads, absgrad, ld, radii_full, _ = grads_impl(model.params, model.alive, w2c, K, image,
                                                       mask, sh_degree)
        like = [getattr(grads, n) for n in PARAM_NAMES] + [absgrad]
        full = col.unpack_rows(col.all_gather_rows(col.pack_rows(like), group_g), like)
        return GaussianParams(**dict(zip(PARAM_NAMES, full[:-1]))), full[-1], ld, radii_full

    return grad_fn


def make_gauss_sharded_train_step(cfg: Config, mesh, render_fn: Callable, height: int,
                                  width: int):
    """The train step over Gaussian-sharded state (the single step's
    signature without ``height``/``width``, with ``in_place``): statistics
    and Adam on this rank's shard, camera and image replicated. Its capture
    contract is ``shard.make_sharded_train_step``'s: tensor or host flags,
    no branch on them, no device value read on the host."""
    grads_impl = build_gauss_grads(cfg, mesh, render_fn, height, width)

    def step(model, adam, w2c, K, image, mask, lr_means, do_stats, skip_all, skip_opac, *,
             sh_degree, in_place: bool = False):
        grads, absgrad, ld, _, radii = grads_impl(model.params, model.alive, w2c, K, image, mask,
                                                  sh_degree)
        stats = update_stats(model.stats, radii, absgrad, do_stats, height, width, in_place)
        model_new, adam_new = _apply_adam(cfg, model, adam, grads, stats, lr_means, skip_all,
                                          skip_opac, in_place)
        return model_new, adam_new, ld

    return step


def shard_seed(seed: int, gauss_idx: int) -> int:
    """A shard's split-noise seed from the event's (the counterpart of
    ``jax.random.fold_in(key, axis_index)``)."""
    return (seed + (gauss_idx + 1) * 0x9E3779B97F4A7C15) % 2**63


def make_sharded_densify_step(dcfg, mesh, graphed=None, max_capacity: int | None = None):
    """Densify and prune over Gaussian-sharded state: the single-device
    engine (``models/density.py``) on each shard, its children in the
    parent's own shard (slot position carries no meaning). ``step(model,
    adam, seed=None, noise=None) -> (model, adam, info, overflow)``: the
    split noise is this shard's ``noise`` [C/G, 3] when given, else drawn
    eagerly from a generator seeded with ``shard_seed(seed, gauss_idx)``.
    Info counts are summed over the gauss group and ``overflow`` is any
    shard's, so every rank grows together. With ``graphed`` (the NCCL
    mesh's graphed step) the event is a program over its state, one per
    shard capacity (``trainer.densify_event``, the two reductions inside
    it), which keeps the overflowing event's state only at the largest
    capacity ``max_capacity`` allows."""
    group_g, n_gauss, g_idx, _ = _gauss(mesh)

    def reduce(vals):
        return torch.cat([col.all_reduce(vals[:1], group_g, "max"),
                          col.all_reduce(vals[1:], group_g)])

    def shard_noise(model, seed):
        gen = torch.Generator(device=model.alive.device).manual_seed(shard_seed(seed, g_idx))
        return torch.randn((model.capacity, 3), generator=gen, dtype=torch.float32,
                           device=model.alive.device)

    def result(model, adam, vals):
        return model, adam, dict(zip(INFO_KEYS, vals[1:].unbind())), vals[0] > 0

    if graphed is None:
        def step(model, adam, seed: int | None = None, noise: torch.Tensor | None = None):
            noise = shard_noise(model, seed) if noise is None else noise
            state, adam_new, info, overflow = densify_and_prune(model, adam, None, dcfg,
                                                                noise=noise)
            vals = reduce(torch.stack([overflow.to(torch.int64)]
                                      + [info[k].to(torch.int64) for k in INFO_KEYS]))
            return result(state, adam_new, vals)

        return step

    def graphed_step(model, adam, seed: int | None = None, noise: torch.Tensor | None = None):
        model, adam = graphed.own(model, adam)
        noise = shard_noise(model, seed) if noise is None else noise
        total = model.capacity * n_gauss
        grown = min(total * 2, max_capacity)
        keep = grown - grown % n_gauss <= total
        vals = graphed.replay(("densify", model.capacity, keep),
                              densify_event(dcfg, keep, reduce), [noise]).out
        return result(*state_from(graphed.state), vals)

    return graphed_step


def grow_state_sharded(state, adam, new_capacity: int, mesh):
    """Grow the (global) capacity with per-shard padding: each shard gains
    ``(new_capacity - capacity) / G`` dead slots (zero, identity quats, zero
    moments), so shard-local densification stays balanced. ``state`` and
    ``adam`` are this rank's shards; returns the grown shards, each leaf
    written in one pass into a tensor allocated once. It runs once a
    capacity, so it stays eager (a graph of it would replay once)."""
    n = mesh.axis_size(GAUSS_AXIS)
    old = state.capacity * n
    if new_capacity % n or new_capacity <= old:
        raise ValueError(
            f"capacities {old}->{new_capacity} must grow and be divisible by the gauss mesh "
            f"size {n}"
        )
    local = new_capacity // n
    return grow_capacity(state, local), grow_adam_state(adam, local - state.capacity)
