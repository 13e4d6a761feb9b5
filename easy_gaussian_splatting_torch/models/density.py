"""Adaptive density control: statistics, clone/split/prune, opacity reset;
counterpart of ``easy_gaussian_splatting_tpu/models/density.py``.

Everything works on the fixed-capacity buffers, as in the JAX package:
clones and splits are written into free slots found by cumsum ranking and
scatter, "removal" clears the alive bit, and a free-slot overflow is
reported so the host grows capacity and retries. The split noise comes from
a ``torch.Generator`` (or an explicit ``noise`` tensor: the trainer's
graphed refine event draws it from the run's generator into its input
buffer, and tests feed both packages the same numbers). Nothing here reads a
device value on the host, so a CUDA graph holds an event and a reset
(``training/trainer.py::densify_event`` and ``reset_event``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.quaternion import quat_to_rotmat
from .gaussians import DensifyStats, GaussianModelState, GaussianParams, zero_stats
from .optimizer import AdamState, mask_moments


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    densify_grad_thresh: float
    densify_scale_thresh: float
    num_splits: int
    prune_radii_ratio_thresh: float
    prune_scale_thresh: float
    min_opacity: float


def update_statistics(
    stats: DensifyStats,
    radii: torch.Tensor,  # [C] pixels
    absgrad: torch.Tensor,  # [C, 2] pixel-unit absolute screen-gradient sums
    height: int,
    width: int,
) -> DensifyStats:
    """For visible Gaussians (radius > 0): accumulate the absgrad norm
    scaled by max(H, W), count the observation, track the max radius
    normalized by max(H, W)."""
    max_hw = float(max(height, width))
    radii_norm = radii / max_hw
    visible = radii > 0.0
    max_radii = torch.where(
        visible, torch.maximum(stats.max_radii, radii_norm), stats.max_radii
    )
    grads = torch.linalg.norm(absgrad, dim=-1) * max_hw
    accum = stats.grad_norm_accum + torch.where(visible, grads, torch.zeros_like(grads))
    counts = stats.collecting_counts + visible.to(torch.float32)
    return DensifyStats(grad_norm_accum=accum, collecting_counts=counts, max_radii=max_radii)


def _scatter_set(base: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``base.at[idx].set(values, mode="drop")`` for distinct in-range
    entries of ``idx``: the out-of-range ones write a spare last row, cut
    off after, so no index is read back on the host (torch's indexing would
    raise on them, and selecting them would size a tensor from the data,
    which a CUDA graph cannot hold)."""
    n = base.shape[0]
    keep = (idx >= 0) & (idx < n)
    out = torch.cat([base, base[:1]])
    where = torch.where(keep, idx, n)
    if isinstance(values, torch.Tensor):
        out[where] = values
    else:  # a number: no tensor made of it (a copy a graph cannot hold)
        out.index_fill_(0, where, values)
    return out[:n]


def _take_fill(table: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``jnp.take(table, idx, mode="fill", fill_value=fill)``."""
    n = table.shape[0]
    inside = (idx >= 0) & (idx < n)
    got = table[torch.clamp(idx, 0, n - 1)]
    return torch.where(inside, got, torch.full_like(got, fill))


def densify_and_prune(
    state: GaussianModelState,
    adam: AdamState,
    generator: torch.Generator | None,
    cfg: DensifyConfig,
    noise: torch.Tensor | None = None,  # [C, 3] N(0, 1) split samples
) -> Tuple[GaussianModelState, AdamState, Dict[str, torch.Tensor], torch.Tensor]:
    """One refine event. Returns (new_state, new_adam, info, overflow)."""
    params = state.params
    alive = state.alive
    stats = state.stats
    cap = state.capacity
    ns = cfg.num_splits
    device = alive.device
    arange = torch.arange(cap, dtype=torch.int64, device=device)

    scales = torch.exp(params.log_scales)
    max_scale = scales.amax(dim=-1)
    opac = torch.sigmoid(params.logit_opacities)

    avg_grad = stats.grad_norm_accum / (stats.collecting_counts + 1e-8)
    avg_grad = torch.nan_to_num(avg_grad, nan=0.0)
    high_grad = (avg_grad >= cfg.densify_grad_thresh) & alive
    big = max_scale >= cfg.densify_scale_thresh
    split_mask = big & high_grad
    clone_mask = (~big) & high_grad

    # prune mask over the old population (split parents are pruned too)
    low_op = opac < cfg.min_opacity
    large_radii = stats.max_radii > cfg.prune_radii_ratio_thresh
    large_scale = max_scale > cfg.prune_scale_thresh
    prune_old = (low_op | large_radii | large_scale | split_mask) & alive
    survivors = alive & ~prune_old

    free = ~survivors
    n_free = free.sum()
    n_clone = clone_mask.sum()
    n_split = split_mask.sum()
    need = n_clone + ns * n_split
    overflow = need > n_free

    # rank r -> r-th free slot
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    table = torch.full((cap,), cap, dtype=torch.int64, device=device)
    table = _scatter_set(table, torch.where(free, free_rank, cap), arange)

    def take_slot(ranks, valid):
        return _take_fill(table, torch.where(valid, ranks, cap), cap)

    src_of = torch.full((cap,), cap, dtype=torch.int64, device=device)
    is_clone_new = torch.zeros(cap, dtype=torch.bool, device=device)
    is_split_new = torch.zeros(cap, dtype=torch.bool, device=device)

    clone_rank = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    clone_tgt = take_slot(clone_rank, clone_mask)
    src_of = _scatter_set(src_of, clone_tgt, arange)
    is_clone_new = _scatter_set(is_clone_new, clone_tgt, True)

    split_rank = torch.cumsum(split_mask.to(torch.int64), 0) - 1
    for s in range(ns):
        r = n_clone + s * n_split + split_rank
        tgt = take_slot(r, split_mask)
        src_of = _scatter_set(src_of, tgt, arange)
        is_split_new = _scatter_set(is_split_new, tgt, True)

    is_new = is_clone_new | is_split_new
    src = torch.where(is_new, src_of, arange)

    gathered = params.map(lambda x: x[src])
    src_scales = torch.exp(gathered.log_scales)

    # split transform: sample from the parent Gaussian, shrink scales
    if noise is None:
        noise = torch.randn((cap, 3), generator=generator, dtype=torch.float32, device=device)
    rot = quat_to_rotmat(gathered.quats)  # [C, 3, 3]
    offset = (rot * (src_scales * noise)[:, None, :]).sum(dim=-1)
    split_means = gathered.means + offset
    split_log_scales = torch.log(torch.clamp(src_scales / (0.8 * ns), min=1e-12))

    def merge(old, new_val):
        m = is_new.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(m, new_val, old)

    sm = is_split_new[:, None]
    new_params = GaussianParams(
        means=merge(params.means, torch.where(sm, split_means, gathered.means)),
        log_scales=merge(
            params.log_scales, torch.where(sm, split_log_scales, gathered.log_scales)
        ),
        quats=merge(params.quats, gathered.quats),
        sh_0=merge(params.sh_0, gathered.sh_0),
        sh_rest=merge(params.sh_rest, gathered.sh_rest),
        logit_opacities=merge(params.logit_opacities, gathered.logit_opacities),
    )

    # the opacity/scale prune checks apply to the appended rows too
    new_opac = torch.sigmoid(gathered.logit_opacities)
    src_max = src_scales.amax(dim=-1)
    new_max_scale = torch.where(is_split_new, src_max / (0.8 * ns), src_max)
    new_low_op = is_new & (new_opac < cfg.min_opacity)
    new_large_scale = is_new & (new_max_scale > cfg.prune_scale_thresh)
    prune_new = new_low_op | new_large_scale
    alive_out = survivors | (is_new & ~prune_new)

    # Adam surgery: keep moments only for surviving old rows
    adam_out = mask_moments(adam, survivors & ~is_new)

    # prune breakdown, incremental like the reference's prune counts
    c0 = (low_op & alive).sum() + new_low_op.sum()
    c1 = ((low_op | large_radii) & alive).sum() + new_low_op.sum()
    c2 = ((low_op | large_radii | large_scale) & alive).sum() + prune_new.sum()
    info = {
        "split": n_split,
        "clone": n_clone,
        "prune_low_opacity": c0,
        "prune_large_radii": c1 - c0,
        "prune_large_scale": c2 - c1,
        "nbr_gaussians": alive_out.sum(),
    }
    new_state = GaussianModelState(
        params=new_params, alive=alive_out, stats=zero_stats(cap, device)
    )
    return new_state, adam_out, info, overflow


def reset_opacities(
    state: GaussianModelState, adam: AdamState, min_opacity: float
) -> Tuple[GaussianModelState, AdamState]:
    """Clamp opacities down to ``min(opacity / 2, 2 * min_opacity)`` and zero
    the opacity group's Adam moments."""
    opac = torch.sigmoid(state.params.logit_opacities)
    target = torch.clamp(opac * 0.5, max=min_opacity * 2.0)
    target = torch.clamp(target, 1e-6, 1.0 - 1e-6)
    logit = torch.log(target) - torch.log1p(-target)
    new_params = dataclasses.replace(state.params, logit_opacities=logit)
    adam_out = mask_moments(adam, torch.zeros_like(state.alive), group="logit_opacities")
    return dataclasses.replace(state, params=new_params), adam_out
