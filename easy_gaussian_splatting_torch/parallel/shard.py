"""Image-stripe sharding of the train step; counterpart of
``easy_gaussian_splatting_tpu/parallel/shard.py`` (its ``shard_map`` body
runs here once per rank).

- Gaussian parameters are replicated: every rank holds the same state and
  takes the same Adam step.
- Each rank renders its stripe of the image as a window of the full
  viewport: projection runs in the full image's geometry (the same conics
  and radii on every rank), then the screen means shift into the stripe
  (``CameraView.full_height``/``y_offset``), and binning's exact
  ellipse/tile test drops what misses it.
- The stripes are gathered (``collectives.gather_rows``) so that the loss
  (L1 + SSIM, whose windows cross stripe edges) is the same on every rank;
  the parameter gradients and absgrad are summed over the ranks, the radii
  take their maximum, the loss terms their mean, and ``isects`` is the
  fullest rank's count (each rank's binning has its own capacity).
- Partitions: ``uniform`` stripes, optionally ``stripe_interleave`` slabs a
  rank, or ``adaptive`` (the default): contiguous stripes bounded at the
  row quantiles of the projected centres, each a full-height window whose
  rows past its ``y_limit`` receive nothing.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.gaussians import PARAM_NAMES, GaussianParams
from ..models.render import CameraView
from ..training.config import Config
from ..training.trainer import (
    _apply_adam,
    _background,
    cfg_loss,
    grad_leaves,
    param_grads,
    update_stats,
)
from . import collectives as col

PARTITIONS = ("uniform", "adaptive")


def _check_height(height: int, n_dev: int) -> int:
    if height % n_dev != 0:
        raise ValueError(f"height {height} must be divisible by mesh size {n_dev}")
    return height // n_dev


def _partition(cfg: Config) -> str:
    if cfg.stripe_partition not in PARTITIONS:
        raise ValueError(
            f"stripe_partition={cfg.stripe_partition!r}: expected one of {', '.join(PARTITIONS)}"
        )
    return cfg.stripe_partition


def effective_interleave(height: int, n_dev: int, want: int) -> int:
    """Largest k <= ``want`` with height divisible by n_dev*k: the slab
    count per rank of the interleaved stripe assignment."""
    k = max(1, int(want))
    while k > 1 and height % (n_dev * k) != 0:
        k -= 1
    return k


def render_striped(render_fn, params, alive, w2c, K, width, height, n_dev, idx,
                   k_slabs, sh_degree, background, absdummy):
    """Render rank ``idx``'s share of the image as ``k_slabs`` interleaved
    slabs (global slabs ``idx, idx + n_dev, ...``); returns (image
    [stripe_h, W, 3], radii, num_isects), the intersection count the
    largest slab's (each slab render has its own capacity)."""
    slab_h = height // n_dev // k_slabs
    imgs, radii, nis = [], None, None
    for j in range(k_slabs):
        y0 = torch.full((), float((j * n_dev + idx) * slab_h), device=w2c.device)
        camera = CameraView(w2c=w2c, K=K, width=width, height=slab_h,
                            full_height=height, y_offset=y0)
        out = render_fn(params, alive, camera, sh_degree, background, absdummy)
        imgs.append(out.image)
        radii = out.radii if radii is None else torch.maximum(radii, out.radii)
        if out.num_isects is not None:
            nis = out.num_isects if nis is None else torch.maximum(nis, out.num_isects)
    image = imgs[0] if k_slabs == 1 else torch.cat(imgs, dim=0)
    return image, radii, nis


def reorder_striped(full, n_dev: int, k_slabs: int, height: int, width: int):
    """Undo the rank-major row order of a gathered interleaved image: the
    gathered rows are (rank i, slab j) blocks, the image's slab-major
    (global slab j * n_dev + i)."""
    if k_slabs == 1:
        return full
    slab_h = height // (n_dev * k_slabs)
    x = full.reshape((n_dev, k_slabs, slab_h) + tuple(full.shape[1:]))
    return x.transpose(0, 1).reshape((height,) + tuple(full.shape[1:]))


@torch.no_grad()
def adaptive_row_bounds(params, alive, w2c, K, height: int, n_parts: int) -> torch.Tensor:
    """Content-adaptive contiguous partition of the image's pixel rows into
    ``n_parts`` stripes at the row quantiles of the projected centres, so
    each carries ~1/n of the content: [n_parts + 1] int32 bounds, the same
    on every rank (computed from replicated inputs)."""
    pc = params.means @ w2c[:3, :3].T + w2c[:3, 3][None, :]
    z = pc[:, 2]
    ok = alive & (z > 1e-2)
    yc = K[1, 1] * pc[:, 1] / torch.clamp(z, min=1e-2) + K[1, 2]
    yc = torch.clamp(yc, 0.0, float(height - 1))
    yc = torch.where(ok, yc, torch.full_like(yc, float("inf")))  # invalid last
    yc_sorted = torch.sort(yc).values
    n_ok = ok.sum(dtype=torch.int32)
    q = torch.arange(1, n_parts, dtype=torch.int32, device=z.device) * n_ok // n_parts
    mids = yc_sorted[torch.clamp(q, 0, yc.shape[0] - 1).long()]
    mids = torch.where(torch.isfinite(mids), mids, torch.zeros_like(mids))
    mids = torch.clamp(mids.to(torch.int32) + 1, 0, height)  # just below the quantile
    bounds = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=z.device), mids,
        torch.full((1,), height, dtype=torch.int32, device=z.device),
    ])
    return torch.cummax(bounds, dim=0).values


def reassemble_adaptive(gathered, bounds_px, n_dev: int, height: int):
    """The full image from ``n_dev`` adaptively bounded windows: ``gathered``
    is [n_dev * H, W, ...] rank-major, rank c's rows [0, bounds[c+1] -
    bounds[c]) are the image's rows from bounds[c]. One differentiable row
    gather."""
    r = torch.arange(height, dtype=torch.int32, device=gathered.device)
    c = torch.searchsorted(bounds_px, r, right=True, out_int32=True) - 1
    c = torch.clamp(c, 0, n_dev - 1)
    idx = c * height + (r - bounds_px[c.long()])
    return gathered[idx.long()]


def stripe_loss(cfg: Config, render_fn: Callable, params, alive, absd, w2c, K, image, mask,
                sh_degree: int, height: int, width: int, n_total: int, idx: int,
                k_slabs: int, bounds_px, group):
    """Render stripe ``idx`` of ``n_total``, gather the image over ``group``
    and compute the loss on it: (loss dict, radii, num_isects or None)."""
    background = _background(cfg, w2c.device)
    if bounds_px is not None:
        camera = CameraView(
            w2c=w2c, K=K, width=width, height=height, full_height=height,
            y_offset=bounds_px[idx].to(torch.float32),
            y_limit=(bounds_px[idx + 1] - bounds_px[idx]).to(torch.float32),
        )
        out = render_fn(params, alive, camera, sh_degree, background, absd)
        stripe, radii, nis = out.image, out.radii, out.num_isects
        full = reassemble_adaptive(col.gather_rows(stripe, group), bounds_px, n_total, height)
    else:
        stripe, radii, nis = render_striped(
            render_fn, params, alive, w2c, K, width, height, n_total, idx, k_slabs,
            sh_degree, background, absd,
        )
        full = reorder_striped(col.gather_rows(stripe, group), n_total, k_slabs, height, width)
    return cfg_loss(cfg, full, image, mask, params, alive), radii, nis


def reduce_losses(ld, nis, group):
    """The loss terms' mean over ``group`` (``pmean``) and, as ``isects``,
    the largest rank's intersection count (``pmax``)."""
    keys = list(ld)
    vals = col.mean(torch.stack([ld[k].detach().to(torch.float32) for k in keys]), group)
    out = dict(zip(keys, vals.unbind()))
    if nis is not None:
        out["isects"] = col.all_reduce(nis.reshape(1), group, "max")[0].to(torch.float32)
    return out


def build_sharded_grads(cfg: Config, mesh, render_fn: Callable, height: int, width: int):
    """The stripe-sharded pre-Adam gradients, shared by the train step and
    ``make_sharded_grad_fn``: ``fn(params, alive, w2c, K, image, mask,
    sh_degree) -> ((grads, absgrad), loss dict, radii)``, the full image's
    gradients (the sum of the stripes', see ``collectives``) on every rank."""
    n_dev = mesh.size
    _check_height(height, n_dev)
    k_slabs = effective_interleave(height, n_dev, cfg.stripe_interleave)
    adaptive = _partition(cfg) == "adaptive"
    group, idx = mesh.world, mesh.stripe_index

    def sharded_grads(params, alive, w2c, K, image, mask, sh_degree):
        bounds = adaptive_row_bounds(params, alive, w2c, K, height, n_dev) if adaptive else None
        leaves, absd = grad_leaves(params, alive.shape[0])
        ld, radii, nis = stripe_loss(cfg, render_fn, leaves, alive, absd, w2c, K, image, mask,
                                     sh_degree, height, width, n_dev, idx, k_slabs, bounds, group)
        grads = param_grads(ld["total"], leaves, absd)
        grads = col.unpack_rows(col.all_reduce(col.pack_rows(grads), group), grads)
        radii = col.all_reduce(radii.detach(), group, "max")
        return (
            (GaussianParams(**dict(zip(PARAM_NAMES, grads[:-1]))), grads[-1]),
            reduce_losses(ld, nis, group),
            radii,
        )

    return sharded_grads


def make_sharded_grad_fn(cfg: Config, mesh, render_fn: Callable, height: int, width: int):
    """Pre-Adam gradients of the stripe-sharded step, for gradient-level
    equivalence tests: ``grad_fn(model, w2c, K, image, mask, *, sh_degree)
    -> (grads, absgrad, loss dict, radii)``."""
    grads_impl = build_sharded_grads(cfg, mesh, render_fn, height, width)

    def grad_fn(model, w2c, K, image, mask, *, sh_degree):
        (grads, absgrad), ld, radii = grads_impl(model.params, model.alive, w2c, K, image, mask,
                                                 sh_degree)
        return grads, absgrad, ld, radii

    return grad_fn


def make_sharded_train_step(cfg: Config, mesh, render_fn: Callable, height: int, width: int):
    """The stripe-sharded train step for one (padded) image size:
    ``step(model, adam, w2c, K, image, mask, lr_means, do_stats, skip_all,
    skip_opac, *, sh_degree, in_place=False) -> (model, adam, loss dict)``,
    the single step's signature without ``height``/``width``, and its
    capture contract: ``lr_means`` and the flags host values or 0-d tensors
    (applied with ``torch.where``, the same bits either way), ``in_place``
    writing the update into the given state's tensors, no device value read
    on the host. ``height`` must be a multiple of the mesh size (the trainer
    pads frames and masks the pad)."""
    grads_impl = build_sharded_grads(cfg, mesh, render_fn, height, width)

    def step(model, adam, w2c, K, image, mask, lr_means, do_stats, skip_all, skip_opac, *,
             sh_degree, in_place: bool = False):
        (grads, absgrad), ld, radii = grads_impl(model.params, model.alive, w2c, K, image, mask,
                                                 sh_degree)
        stats = update_stats(model.stats, radii, absgrad, do_stats, height, width, in_place)
        model_new, adam_new = _apply_adam(cfg, model, adam, grads, stats, lr_means, skip_all,
                                          skip_opac, in_place)
        return model_new, adam_new, ld

    return step


def make_striped_isect_counter(
    mesh,
    tile_size: int,
    max_tiles_w: int,
    max_tiles_h: int,
    ov_frac: float = 0.125,
    small_budget: int | None = None,
    reduce: str = "max",
    interleave: int = 1,
    partition: str = "adaptive",
):
    """Mesh-aware intersection counter: bins this rank's stripe exactly as
    the sharded tiled step does (rows padded to a multiple of the mesh size
    times ``interleave``, the same slabs or adaptive window) and returns,
    over the whole mesh, the maximum of [num_isects, num_overflow, *n_gt]:
    what each rank's capacities must cover (for slabs, the largest slab).
    ``reduce="none"`` returns the per-rank matrix [n_dev, 2 +
    len(BUDGET_CANDIDATES)] instead, entry 0 the rank's total over its slabs
    (its binning work, the load-balance diagnostic). ``params`` is the full
    population, on every rank."""
    from ..ops.projection import CameraIntrinsics, project_gaussians
    from ..ops.rasterize_tiled import (
        SMALL_BUDGET,
        _ov_capacity,
        bin_gaussians,
        binning_extents,
        image_geometry,
    )

    if small_budget is None:
        small_budget = SMALL_BUDGET
    if reduce not in ("max", "none"):
        raise ValueError(f"reduce={reduce!r}: expected 'max' or 'none'")
    if partition not in PARTITIONS:
        raise ValueError(f"partition={partition!r}: expected one of {', '.join(PARTITIONS)}")
    n_dev, idx, group = mesh.size, mesh.stripe_index, mesh.world

    @torch.no_grad()
    def count(params, alive, w2c, K, *, height, width):
        unit = n_dev * max(1, interleave)
        hp = -(-height // unit) * unit
        k_slabs = effective_interleave(hp, n_dev, interleave)
        slab_h = hp // n_dev // k_slabs
        c = params.means.shape[0]
        opac = torch.sigmoid(params.logit_opacities) * alive.to(torch.float32)
        intr = CameraIntrinsics.from_K(K, width, hp)
        proj = project_gaussians(params.means, params.quats, torch.exp(params.log_scales),
                                 w2c, intr)
        radii = torch.where(opac > 0.0, proj.radii, torch.zeros_like(proj.radii))
        extents = binning_extents(proj.conics, opac, radii)

        def bin_window(y0, geom, y_lim):
            shift = torch.stack([torch.zeros_like(y0), y0])
            b = bin_gaussians(
                proj.means2d - shift[None, :], extents, proj.depths, geom, max_tiles_w,
                max_tiles_h, conics=proj.conics, opacities=opac,
                ov_capacity=_ov_capacity(c, ov_frac), small_budget=small_budget, y_limit=y_lim,
            )
            return torch.cat([torch.stack([b.num_isects, b.num_overflow]), b.n_gt])

        if partition == "adaptive":
            bounds = adaptive_row_bounds(params, alive, w2c, K, hp, n_dev)
            local = bin_window(bounds[idx].to(torch.float32), image_geometry(hp, width, tile_size),
                               (bounds[idx + 1] - bounds[idx]).to(torch.float32))
            total = local[0]
        else:
            geom = image_geometry(slab_h, width, tile_size)
            local = total = None
            for j in range(k_slabs):
                y0 = torch.full((), float((j * n_dev + idx) * slab_h), device=w2c.device)
                # the render's own limit: the slab's height
                cur = bin_window(y0, geom, float(slab_h))
                local = cur if local is None else torch.maximum(local, cur)
                total = cur[0] if total is None else total + cur[0]
        if reduce == "none":
            local = local.clone()
            local[0] = total
            return col.all_gather_rows(local[None, :], group)
        return col.all_reduce(local, group, "max")

    return count
