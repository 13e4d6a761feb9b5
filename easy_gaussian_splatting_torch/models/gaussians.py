"""Gaussian parameter state: a fixed-capacity, alive-masked set of tensors;
counterpart of ``easy_gaussian_splatting_tpu/models/gaussians.py``.

Six per-Gaussian tensors — ``means [C,3]``, ``log_scales [C,3]``, ``quats
[C,4]`` (wxyz), ``sh_0 [C,1,3]``, ``sh_rest [C,K-1,3]``,
``logit_opacities [C]`` — live in capacity-``C`` buffers with an ``alive``
mask, as in the JAX package, so a checkpoint carries the same arrays in
either package. Dataclasses take the place of the ``flax.struct`` pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import knn_dists
from ..ops.sh import num_sh_bases, rgb_to_sh0

PARAM_NAMES = (
    "means",
    "log_scales",
    "quats",
    "sh_0",
    "sh_rest",
    "logit_opacities",
)


@dataclasses.dataclass
class GaussianParams:
    means: torch.Tensor  # [C, 3]
    log_scales: torch.Tensor  # [C, 3]
    quats: torch.Tensor  # [C, 4] wxyz
    sh_0: torch.Tensor  # [C, 1, 3]
    sh_rest: torch.Tensor  # [C, K-1, 3]
    logit_opacities: torch.Tensor  # [C]

    def map(self, fn) -> "GaussianParams":
        return GaussianParams(**{n: fn(getattr(self, n)) for n in PARAM_NAMES})


@dataclasses.dataclass
class DensifyStats:
    """Densification statistics: accumulated screen-gradient norms,
    observation counts and max normalized screen radii."""

    grad_norm_accum: torch.Tensor  # [C]
    collecting_counts: torch.Tensor  # [C]
    max_radii: torch.Tensor  # [C]

    def map(self, fn) -> "DensifyStats":
        return DensifyStats(
            grad_norm_accum=fn(self.grad_norm_accum),
            collecting_counts=fn(self.collecting_counts),
            max_radii=fn(self.max_radii),
        )


@dataclasses.dataclass
class GaussianModelState:
    params: GaussianParams
    alive: torch.Tensor  # [C] bool
    stats: DensifyStats

    @property
    def capacity(self) -> int:
        return self.params.means.shape[0]

    def num_alive(self) -> int:
        return int(self.alive.sum())


def zero_stats(capacity: int, device) -> DensifyStats:
    return DensifyStats(
        grad_norm_accum=torch.zeros(capacity, dtype=torch.float32, device=device),
        collecting_counts=torch.zeros(capacity, dtype=torch.float32, device=device),
        max_radii=torch.zeros(capacity, dtype=torch.float32, device=device),
    )


def _round_up_capacity(n: int) -> int:
    """Smallest ladder capacity >= n; rungs are pow2 and 1.5*pow2
    (1024, 1536, 2048, 3072, ...)."""
    cap = 1024
    while True:
        if cap >= n:
            return cap
        if cap + cap // 2 >= n:
            return cap + cap // 2
        cap *= 2


def params_from_numpy(
    arrays: Dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> GaussianParams:
    """Parameters from the JAX package's arrays (as numpy, by PARAM_NAMES)."""
    dev = resolve_device(device)
    return GaussianParams(
        **{
            n: torch.as_tensor(np.asarray(arrays[n], np.float32)).to(dev)
            for n in PARAM_NAMES
        }
    )


def params_to_numpy(params: GaussianParams) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`."""
    return {n: getattr(params, n).detach().cpu().numpy() for n in PARAM_NAMES}


def init_gaussian_state(
    xyzs: np.ndarray,  # [N, 3] float
    rgbs: np.ndarray,  # [N, 3] uint8
    sh_degree: int,
    capacity: int | None = None,
    init_opacity: float = 0.8,
    device: str | torch.device = "cuda",
) -> GaussianModelState:
    """Initialize from a point cloud: scales = mean 3-NN distance / 2
    (log-stored), identity quats, DC SH from RGB, opacity 0.8
    (logit-stored); dead slots keep identity quats."""
    dev = resolve_device(device)
    n = xyzs.shape[0]
    if capacity is None:
        capacity = _round_up_capacity(int(n * 1.3))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of points {n}")

    dists = knn_dists(np.asarray(xyzs, np.float32), k=3, device=dev)
    avg_dist = dists.mean(axis=1, keepdims=True)
    scales = np.repeat(avg_dist, 3, axis=1) / 2.0
    log_scales = np.log(np.maximum(scales, 1e-12))

    dim_sh = num_sh_bases(sh_degree)
    sh_0 = rgb_to_sh0(np.asarray(rgbs, np.float32) / 255.0)[:, None, :]
    sh_rest = np.zeros((n, dim_sh - 1, 3), np.float32)
    logit_op = float(np.log(init_opacity) - np.log1p(-init_opacity))

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quats = np.zeros((capacity, 4), np.float32)
    quats[:, 0] = 1.0
    params = params_from_numpy(
        dict(
            means=pad(np.asarray(xyzs, np.float32)),
            log_scales=pad(log_scales),
            quats=quats,
            sh_0=pad(sh_0),
            sh_rest=pad(sh_rest),
            logit_opacities=pad(np.full((n,), logit_op, np.float32)),
        ),
        dev,
    )
    alive = torch.arange(capacity, device=dev) < n
    return GaussianModelState(params=params, alive=alive, stats=zero_stats(capacity, dev))


def grow_capacity(state: GaussianModelState, new_capacity: int,
                  out: GaussianModelState | None = None) -> GaussianModelState:
    """Re-pad every buffer to a larger capacity: new rows are dead, zero,
    with identity quats. Each leaf is written in one pass into a tensor
    allocated once, or into ``out``'s (a state of ``new_capacity``)."""
    old = state.capacity
    if new_capacity <= old:
        raise ValueError(f"new capacity {new_capacity} <= current {old}")

    def new(x):
        return x.new_empty((new_capacity,) + tuple(x.shape[1:]))

    if out is None:
        out = GaussianModelState(params=state.params.map(new), alive=new(state.alive),
                                 stats=state.stats.map(new))
    elif out.capacity != new_capacity:
        raise ValueError(f"out has capacity {out.capacity}, not {new_capacity}")
    srcs = [getattr(state.params, n) for n in PARAM_NAMES] + [state.alive] + [
        getattr(state.stats, f.name) for f in dataclasses.fields(DensifyStats)]
    dsts = [getattr(out.params, n) for n in PARAM_NAMES] + [out.alive] + [
        getattr(out.stats, f.name) for f in dataclasses.fields(DensifyStats)]
    for src, dst in zip(srcs, dsts):
        dst[:old].copy_(src)
        dst[old:].zero_()
    out.params.quats[old:, 0] = 1.0
    return out


def compact_capacity(
    state: GaussianModelState, new_capacity: int
) -> tuple[GaussianModelState, torch.Tensor]:
    """Permute alive rows to the buffer front (order kept) and shrink to
    ``new_capacity``. Returns (new_state, perm)."""
    n_alive = state.num_alive()
    if new_capacity < n_alive:
        raise ValueError(f"new capacity {new_capacity} < alive count {n_alive}")
    if new_capacity > state.capacity:
        raise ValueError(
            f"new capacity {new_capacity} > current {state.capacity}; "
            "use grow_capacity"
        )
    perm = torch.argsort((~state.alive).to(torch.int8), stable=True)[:new_capacity]

    def take(x):
        return x[perm]

    return (
        GaussianModelState(
            params=state.params.map(take),
            alive=take(state.alive),
            stats=state.stats.map(take),
        ),
        perm,
    )


def compact_for_inference(state: GaussianModelState) -> GaussianModelState:
    """Shrink a loaded checkpoint to the smallest ladder capacity holding
    its alive population (forward-only consumers such as the viewer):
    every per-capacity render cost scales with capacity, and dead slots
    have zero opacity, so outputs are identical."""
    want = _round_up_capacity(max(state.num_alive(), 1))
    if want >= state.capacity:
        return state
    return compact_capacity(state, want)[0]
