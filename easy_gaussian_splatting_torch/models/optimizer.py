"""Grouped Adam with densification-compatible moment surgery; counterpart of
``easy_gaussian_splatting_tpu/models/optimizer.py``.

One Adam over six named parameter groups with distinct learning rates
(torch defaults: betas 0.9 / 0.999, eps 1e-8 added after the bias-
corrected square root). Moments live in capacity-padded buffers shaped like
the parameters, so "surgery" at a densify event is masked zeroing; each
group has its own step count, and a group whose parameter was re-created
this step (densify: all six; opacity reset: ``logit_opacities``) skips its
update entirely (:func:`select`: a ``torch.where`` on a 0-d flag, which
may live on the device). Every function here returns new tensors, as the
JAX package's do, except :func:`adam_update` with ``in_place`` (the
graphed step's, which writes into its donated buffers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .gaussians import PARAM_NAMES, GaussianParams

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-8


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    steps: Dict[str, torch.Tensor]  # per-group 0-dim i32


def select(flag: bool | torch.Tensor, if_true: torch.Tensor, if_false: torch.Tensor,
           out: torch.Tensor | None = None):
    """``torch.where(flag, if_true, if_false)`` for a 0-d bool tensor; for a
    host bool, the chosen tensor itself. ``where`` copies the chosen value
    exactly, so both give the same bits, and a host bool makes no tensor
    on the device (that copy would wait for the card). With ``out`` (which
    may be one of the two), the choice is written there and returned."""
    if isinstance(flag, torch.Tensor):
        if out is None:
            return torch.where(flag, if_true, if_false)
        return torch.where(flag, if_true, if_false, out=out)
    chosen = if_true if flag else if_false
    if out is None or chosen is out:
        return chosen
    return out.copy_(chosen)


def init_adam_state(params: GaussianParams) -> AdamState:
    device = params.means.device
    return AdamState(
        mu=params.map(torch.zeros_like),
        nu=params.map(torch.zeros_like),
        steps={name: torch.zeros((), dtype=torch.int32, device=device) for name in PARAM_NAMES},
    )


def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: Dict[str, float | torch.Tensor],  # per-group learning rate (0-d tensor or number)
    skips: Dict[str, bool | torch.Tensor] | None = None,  # per-group: skip the update
    in_place: bool = False,
) -> tuple[GaussianParams, AdamState]:
    """One Adam step per group. The bias corrections ``1 - beta**t`` are
    taken in f32 on the step tensor, as the JAX package computes them. A
    skip keeps the group's parameter, moments and step count: a 0-d bool
    tensor through ``torch.where``, as the JAX package's traced skips do (so
    one captured step serves skipped and updated steps alike), a bool on the
    host with no tensor made (see :func:`select`). With ``in_place`` the
    new parameters, moments and step counts are written into the tensors of
    ``params`` and ``state``, which are returned (the same bits; the graphed
    step's donated buffers, so that no second copy of the state is made).
    CPU tensors take ``ops/kernels/adam.py::adam_plain``; on the card one
    launch of ``csrc/adam.cu`` updates every group, with the same bits.
    Gradients that are views (the sharded steps' unpacked collectives) are
    made contiguous first."""
    from ..ops.kernels.adam import adam_step  # which imports this module

    return adam_step(params, grads.map(torch.Tensor.contiguous), state, lrs, skips, in_place)


def mask_moments(
    state: AdamState, keep_mask: torch.Tensor, group: str | None = None
) -> AdamState:
    """Zero the Adam moments where ``keep_mask`` is False (surgery for
    densify/prune/opacity reset). ``group=None`` applies to all groups."""

    def apply(tree: GaussianParams) -> GaussianParams:
        out = {}
        for name in PARAM_NAMES:
            x = getattr(tree, name)
            if group is not None and name != group:
                out[name] = x
            else:
                m = keep_mask.reshape((-1,) + (1,) * (x.dim() - 1))
                out[name] = torch.where(m, x, torch.zeros_like(x))
        return GaussianParams(**out)

    return AdamState(mu=apply(state.mu), nu=apply(state.nu), steps=state.steps)


def permute_adam_state(state: AdamState, perm: torch.Tensor) -> AdamState:
    """Apply a row permutation/selection to the moment buffers (capacity
    compaction keeps moments aligned with their Gaussians)."""

    def take(x):
        return x[perm]

    return AdamState(mu=state.mu.map(take), nu=state.nu.map(take), steps=state.steps)


def grow_adam_state(state: AdamState, extra: int, out: AdamState | None = None) -> AdamState:
    """Pad moment buffers for capacity growth (new rows zero): each written
    in one pass into a tensor allocated once, or into ``out``'s (an Adam
    state ``extra`` rows larger, whose step counts take this state's)."""
    old = state.mu.means.shape[0]

    def new(x):
        return x.new_empty((old + extra,) + tuple(x.shape[1:]))

    if out is None:
        out = AdamState(mu=state.mu.map(new), nu=state.nu.map(new), steps=state.steps)
    else:
        for name in PARAM_NAMES:
            out.steps[name].copy_(state.steps[name])
    for tree, dst_tree in ((state.mu, out.mu), (state.nu, out.nu)):
        for name in PARAM_NAMES:
            src, dst = getattr(tree, name), getattr(dst_tree, name)
            dst[:old].copy_(src)
            dst[old:].zero_()
    return out
