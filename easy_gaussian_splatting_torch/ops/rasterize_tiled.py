"""Tiled rasterization: binning + per-tile depth-ordered compositing;
counterpart of ``easy_gaussian_splatting_tpu/ops/rasterize_tiled.py``.

- Each Gaussian's depth RANK (a double argsort) rides in the sort key, so
  every intersection addresses the caller's arrays by original index.
- Binning is two-population: population A holds every Gaussian's first
  ``small_budget`` window cells, population B the ``ov_capacity`` Gaussians
  whose window is larger, with all ``max_tiles_w * max_tiles_h`` cells.
  Each population's keys come from the exact ellipse/tile test; one sort
  of the int64 keys ``(tile << rank_bits) | rank`` orders intersections
  tile-major, depth-minor, and ``searchsorted`` gives the CSR
  ``tile_offsets``.
- Per-intersection features are packed once, with the Gaussian's
  quadratic form as a tile-local polynomial, and the ``tiled_forward``
  kernel composites each tile.
- The gradient is a ``torch.autograd.Function`` (the JAX package's
  custom-VJP core): the ``tiled_backward`` kernel writes one gradient row
  per intersection, and a reduction sums each Gaussian's rows. Its absgrad
  side channel is the gradient of ``absgrad_dummy``.

Two module switches, read at import from the environment and checked at
first use (an unknown value raises), select the JAX package's variants;
values and defaults are the JAX package's (``EGS_TPU_BWD_REDUCE``,
``EGS_TPU_BINNING``), the variable names the port's own:

``BWD_REDUCE`` (``EGS_TORCH_BWD_REDUCE``), the backward reduction:
  - ``band`` (default): a stable sort by flat duplicate id groups each
    Gaussian's rows, the ``segsum_band`` kernel sums each group onto its
    first row, one gather picks the group starts. Windows of more than
    ``segments.LOOK`` cells fall back to ``scan``, as in JAX.
  - ``scan``: the same sort and gather around a log-step segmented suffix
    scan in plain tensor ops (the JAX package's XLA scan).
  - ``pallas``: the same sort, then the ``segsum_compact`` kernel (one row
    per present Gaussian) and the ``monotone_expand`` kernel (back to one
    row per Gaussian).
  - ``dense``: binning carries each entry's dense duplicate-slot id through
    its sort; the backward inverts that permutation, gathers the rows into
    the dense grid and sums each Gaussian's fixed-stride run with the
    ``group_reduce`` kernel. Forces the grid binning.
``BINNING_IMPL`` (``EGS_TORCH_BINNING``), the binning grid:
  - ``pallas`` (default): the hand-written ``binkeys`` CUDA kernel builds
    both populations' keys, flats and counts in one launch;
  - ``xla``: the ``[C, M]`` duplicate grid in plain tensor ops (the JAX
    package's XLA grid), with the same exact test in the same term order.

Gaussians covering more than ``max_tiles_w * max_tiles_h`` tiles are
clamped to a window centered on their tile, as in the JAX package. A 0-d
``y_limit`` (rows, default the window's height) bins only rows ``[0,
y_limit)`` of the window: the multi-device path renders an image stripe
through a window whose rows past its limit receive nothing
(``parallel/shard.py``'s adaptive partition).
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import torch

from .kernels import binkeys as binkeys_kernel
from .kernels import group_reduce as group_reduce_kernel
from .kernels import segments, tile_raster
from .projection import CameraIntrinsics, project_gaussians
from .rasterize_ref import ALPHA_THRESH

DEFAULT_TILE = 32
DEFAULT_MAX_TILES_W = 4
DEFAULT_MAX_TILES_H = 4

# The intersection capacity is rounded up to this quantum, as in the JAX
# package, so both packages truncate at the same capacity.
ISECT_ALIGN = 128
# Intersection indices (CSR offsets, `last`) are int32 in the kernels.
ISECT_ROW_LIMIT = 2**31 - 1
# Device-memory budget per intersection slot, the JAX package's figure:
# forward features plus the training backward's gradient rows.
ISECT_SLOT_BYTES = 320

SMALL_BUDGET = 9
BUDGET_CANDIDATES = (2, 4, 9)

# backward reduction and binning grid (see the module docstring); tests
# switch them by setting the attribute
BWD_REDUCE = os.environ.get("EGS_TORCH_BWD_REDUCE", "band")
BINNING_IMPL = os.environ.get("EGS_TORCH_BINNING", "pallas")
BWD_REDUCE_CHOICES = ("band", "scan", "pallas", "dense")
BINNING_CHOICES = ("pallas", "xla")


def _switch(name: str, value: str, choices) -> str:
    if value not in choices:
        raise ValueError(f"{name}={value!r}: expected one of {', '.join(choices)}")
    return value


def _bwd_reduce() -> str:
    """The backward reduction ``BWD_REDUCE`` names; raises on an unknown value."""
    return _switch("BWD_REDUCE", BWD_REDUCE, BWD_REDUCE_CHOICES)


def _binning_impl() -> str:
    """The binning grid ``BINNING_IMPL`` names; raises on an unknown value."""
    return _switch("BINNING_IMPL", BINNING_IMPL, BINNING_CHOICES)


def max_isect_cap(hbm_budget_mb: float) -> int:
    """Largest intersection capacity inside the configured memory budget
    and the int32 index range."""
    return min(int(hbm_budget_mb * 1e6 / ISECT_SLOT_BYTES), ISECT_ROW_LIMIT)


def isect_capacity(c: int, isect_mult: float) -> int:
    """Intersection capacity of a ``c``-Gaussian render at ``isect_mult``."""
    cap = -(-max(1, int(c * isect_mult)) // ISECT_ALIGN) * ISECT_ALIGN
    return min(cap, (ISECT_ROW_LIMIT // ISECT_ALIGN) * ISECT_ALIGN)


class TiledGeometry(NamedTuple):
    tiles_x: int
    tiles_y: int
    tile_size: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def image_geometry(height: int, width: int, tile_size: int) -> TiledGeometry:
    return TiledGeometry(
        tiles_x=-(-width // tile_size),
        tiles_y=-(-height // tile_size),
        tile_size=tile_size,
    )


class Binning(NamedTuple):
    """CSR per-tile intersection lists, depth-ordered within each tile,
    indexed in original Gaussian order."""

    order: torch.Tensor  # [C] depth argsort (invalid gaussians at the end)
    isect_orig: torch.Tensor  # [D] original gaussian index, tile-grouped
    isect_flat: torch.Tensor  # [D] flat duplicate id orig*M+j (C*M = dead)
    isect_tile: torch.Tensor  # [D] tile id per intersection (T = dead)
    tile_offsets: torch.Tensor  # [T+1] i32
    num_isects: torch.Tensor  # [] i32
    counts: torch.Tensor  # [C] live duplicates per gaussian
    num_overflow: torch.Tensor  # [] i32: gaussians needing > small_budget cells
    n_gt: torch.Tensor  # [len(BUDGET_CANDIDATES)] i32: windows above each budget
    # the dense reduction's side channel (grid binning only): the sort
    # domain is a permutation of dense duplicate slots (population A
    # c*b_small + j, population B C*b_small + s*M + j), so the slot id
    # carried through the sort lets the backward move rows into a grid
    # where each Gaussian's rows sit at a fixed stride
    dense: torch.Tensor | None = None  # [D] i64 dense slot per sorted entry
    # (under BWD_REDUCE == "dense"; full sort domain, never truncated)
    in_ov: torch.Tensor | None = None  # [C] bool: gaussian is in population B
    ov_rank: torch.Tensor | None = None  # [C] i32 its B slot (where in_ov)


def _s_max(opacities: torch.Tensor) -> torch.Tensor:
    """Contributing-ellipse bound sigma <= ln(opac / ALPHA_THRESH), capped at
    the 3-sigma convention (4.5 = 3^2 / 2)."""
    s = torch.log(torch.clamp(opacities, min=1e-12) / ALPHA_THRESH)
    return torch.clamp(s, 0.0, 4.5)


def binning_extents(
    conics: torch.Tensor,  # [C, 3]
    opacities: torch.Tensor,  # [C]
    radii: torch.Tensor,  # [C] circle radius (0 = culled)
) -> torch.Tensor:
    """Per-axis half-widths [C, 2] of each Gaussian's contributing screen
    support {alpha >= ALPHA_THRESH}, capped by the 3-sigma radius."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    det_inv = torch.clamp(a * c - b * b, min=1e-12)
    cov00 = torch.clamp(c / det_inv, min=0.0)
    cov11 = torch.clamp(a / det_inv, min=0.0)
    s_max = _s_max(opacities)
    rx = torch.sqrt(2.0 * s_max * cov00)
    ry = torch.sqrt(2.0 * s_max * cov11)
    live = (radii > 0.0) & (opacities > ALPHA_THRESH)
    zero = torch.zeros_like(rx)
    rx = torch.where(live, torch.minimum(rx, radii), zero)
    ry = torch.where(live, torch.minimum(ry, radii), zero)
    return torch.stack([rx, ry], dim=1)


def _grid_keys(live, tiles, ranks, rank_bits: int, num_tiles: int) -> torch.Tensor:
    """int64 sort keys ``(tile << rank_bits) | rank``, tile ``num_tiles`` where
    dead (the ``binkeys`` kernel's encoding)."""
    t = torch.where(live, tiles, torch.full_like(tiles, num_tiles)).to(torch.int64)
    return (t << rank_bits) | ranks.to(torch.int64)[:, None]


def _bin_grid(
    *, c, m, ts, tx_n, num_tiles, b_small, ov_capacity, two_pop, rank_bits,
    want_dense, rank, mx, my, tx0, ty0, w, count, in_ov, ov_rank, ov_id, conics, opacities,
):
    """The JAX package's ``[C, M]`` duplicate grid (``rasterize_tiled.py:
    438-616``) in plain tensor ops: window cells, the exact ellipse/tile test
    (the plain ``binkeys``' own, so both binnings drop the same cells), the
    two-population split and the dense slot ids. Returns the sort domain's
    keys, flats and dense ids (None unless ``want_dense``), the counts, and
    ``in_ov``/``ov_rank`` (None for one population)."""
    device = mx.device
    j = torch.arange(m, dtype=torch.int32, device=device)[None, :]  # [1, M]
    w_safe = torch.clamp(w, min=1)[:, None]
    jy = torch.div(j, w_safe, rounding_mode="floor")
    jx = j - jy * w_safe
    tile = (ty0[:, None] + jy) * tx_n + tx0[:, None] + jx  # [C, M]
    x0 = ((tx0[:, None] + jx) * ts).to(torch.float32) - mx[:, None]
    y0 = ((ty0[:, None] + jy) * ts).to(torch.float32) - my[:, None]
    s_min = binkeys_kernel.tile_sigma_min(
        x0, y0, ts, conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    )
    # count is 0 for invalid gaussians, so this also tests validity
    live = (j < count[:, None]) & (s_min <= _s_max(opacities)[:, None])
    del x0, y0, s_min
    arange_c = torch.arange(c, dtype=torch.int32, device=device)
    base_flat = arange_c[:, None] * m + j  # [C, M] flat id orig*M + j
    sentinel = torch.full((), c * m, dtype=torch.int32, device=device)
    if not two_pop:
        counts = live.sum(dim=1, dtype=torch.int32)
        keys = _grid_keys(live, tile, rank, rank_bits, num_tiles).reshape(-1)
        flats = torch.where(live, base_flat, sentinel).reshape(-1)
        dense = base_flat.to(torch.int64).reshape(-1) if want_dense else None
        return keys, flats, dense, counts, None, None

    # A: [C, b_small], every gaussian's first cells; B: [ov_capacity, M],
    # the big-window gaussians compacted in index order, with all cells
    slot_valid = ov_id < c
    safe_id = torch.clamp(ov_id, max=c - 1)
    live_adj = live & (in_ov[:, None] | (j < b_small))
    counts = live_adj.sum(dim=1, dtype=torch.int32)
    live_a = live_adj[:, :b_small] & ~in_ov[:, None]
    live_b = live_adj[safe_id] & slot_valid[:, None]
    keys = torch.cat([
        _grid_keys(live_a, tile[:, :b_small], rank, rank_bits, num_tiles).reshape(-1),
        _grid_keys(live_b, tile[safe_id], rank[safe_id], rank_bits, num_tiles).reshape(-1),
    ])
    flats = torch.cat([
        torch.where(live_a, base_flat[:, :b_small], sentinel).reshape(-1),
        torch.where(live_b, base_flat[safe_id], sentinel).reshape(-1),
    ])
    dense = None
    if want_dense:
        # A slots c*b_small + j, B slots C*b_small + s*M + j: a permutation
        # of [0, D) whatever is live (dead entries keep their slot)
        jj = torch.arange(m, dtype=torch.int64, device=device)[None, :]
        slots_b = torch.arange(ov_capacity, dtype=torch.int64, device=device)[:, None]
        dense = torch.cat([
            (arange_c.to(torch.int64)[:, None] * b_small + jj[:, :b_small]).reshape(-1),
            (c * b_small + slots_b * m + jj).reshape(-1),
        ])
    return keys, flats, dense, counts, in_ov, ov_rank


def bin_gaussians(
    means2d: torch.Tensor,  # [C, 2]
    extents: torch.Tensor,  # [C, 2] per-axis half-widths, or [C] radii
    depths: torch.Tensor,  # [C]
    geom: TiledGeometry,
    max_tiles_w: int,
    max_tiles_h: int,
    conics: torch.Tensor,  # [C, 3] for the exact tile test
    opacities: torch.Tensor,  # [C]
    ov_capacity: int | None = None,  # population-B slots (None: C//8)
    small_budget: int = SMALL_BUDGET,  # population-A cells per gaussian
    y_limit: torch.Tensor | float | None = None,  # rows: gaussians whose
    # support starts at or below this row are not binned, and windows end
    # above it (a 0-d tensor, which may differ per call; the tile grid's
    # padding rows and a stripe's rows past its limit)
) -> Binning:
    """Binning through the ``binkeys`` kernel, or through the ``[C, M]``
    grid when ``BINNING_IMPL`` is ``xla`` or ``BWD_REDUCE`` is ``dense``
    (whose side channel only the grid carries), as in the JAX package."""
    want_dense = _bwd_reduce() == "dense"
    use_grid = _binning_impl() == "xla" or want_dense
    device = means2d.device
    c = means2d.shape[0]
    ts = geom.tile_size
    tx_n, ty_n = geom.tiles_x, geom.tiles_y
    num_tiles = geom.num_tiles
    m = max_tiles_w * max_tiles_h
    if c * m >= 2**31:
        raise ValueError(f"{c} gaussians x {m} cells exceed int32 flat ids")

    if extents.dim() == 1:
        extents = torch.stack([extents, extents], dim=1)
    valid = (extents[:, 0] > 0.0) & (extents[:, 1] > 0.0)
    rx, ry = extents[:, 0], extents[:, 1]
    mx, my = means2d[:, 0], means2d[:, 1]
    lim_row = None
    if isinstance(y_limit, torch.Tensor):
        valid = valid & ((my - ry) < y_limit)
        lim_row = torch.clamp(torch.ceil(y_limit / ts).to(torch.int32), min=1)
    elif y_limit is not None:  # a number: no tensor made, no copy to the card
        valid = valid & ((my - ry) < float(y_limit))
        lim_row = max(math.ceil(float(y_limit) / ts), 1)
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(valid, depths, inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(c, device=device)

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int32)

    tx0, tx1 = tile_of(mx - rx, tx_n - 1), tile_of(mx + rx, tx_n - 1)
    ty0, ty1 = tile_of(my - ry, ty_n - 1), tile_of(my + ry, ty_n - 1)
    if lim_row is not None:
        # a valid gaussian starts above the limit; ty1 >= ty0 keeps the
        # window arithmetic sane for the rest, which is masked out
        ty1 = torch.maximum(torch.clamp(ty1, max=lim_row - 1), ty0)

    # flexible window: any w x h <= m; an oversized rect shrinks its larger
    # side, re-centered on the Gaussian's tile
    cx = torch.clamp(torch.floor(mx / ts).to(torch.int32), tx0, tx1)
    cy = torch.clamp(torch.floor(my / ts).to(torch.int32), ty0, ty1)
    w = torch.clamp(tx1 - tx0 + 1, max=m)
    h = torch.clamp(ty1 - ty0 + 1, max=m)
    over = w * h > m
    shrink_w = over & (w >= h)
    w = torch.where(shrink_w, torch.clamp(m // h, min=1), w)
    h = torch.where(over & ~shrink_w, torch.clamp(m // w, min=1), h)
    tx0 = torch.clamp(cx - (w - 1) // 2, tx0, tx1 - w + 1)
    ty0 = torch.clamp(cy - (h - 1) // 2, ty0, ty1 - h + 1)
    count = torch.where(valid, w * h, torch.zeros_like(w))

    if ov_capacity is None:
        ov_capacity = min(c, max(c // 8, 128))
    b_small = max(1, min(small_budget, m))
    flag = valid & (count > b_small)
    num_overflow = flag.sum(dtype=torch.int32)
    n_gt = torch.stack(
        [(valid & (count > bb)).sum(dtype=torch.int32) for bb in BUDGET_CANDIDATES]
    )
    rank_bits = max(1, (c - 1).bit_length())
    two_pop = m > b_small and ov_capacity > 0

    flag_i = flag.to(torch.int32)
    ov_rank = torch.cumsum(flag_i, 0, dtype=torch.int32) - flag_i
    in_ov = flag & (ov_rank < ov_capacity)
    # population B: the overflow gaussians, compacted in index order
    ov_id = torch.sort(torch.where(in_ov, torch.arange(c, device=device), c)).values[:ov_capacity]
    pops = dict(
        c=c, m=m, ts=ts, tx_n=tx_n, num_tiles=num_tiles, b_small=b_small,
        two_pop=two_pop, rank_bits=rank_bits, rank=rank, mx=mx, my=my, tx0=tx0,
        ty0=ty0, w=w, count=count, in_ov=in_ov, ov_id=ov_id, conics=conics,
        opacities=opacities,
    )
    dense = None
    if use_grid:
        keys_dom, flats_dom, dense_dom, counts, in_ov_out, ov_rank_out = _bin_grid(
            ov_capacity=ov_capacity, want_dense=want_dense, ov_rank=ov_rank, **pops
        )
    else:
        keys_dom, flats_dom, counts = _bin_binkeys(valid=valid, **pops)
        in_ov_out = ov_rank_out = None

    # live keys are unique, dead entries of one gaussian tie: any sort order
    # agrees on the live prefix
    sorted_keys, perm = torch.sort(keys_dom)
    sorted_flat = flats_dom[perm]
    if want_dense:
        dense = dense_dom[perm]
    sorted_tile = (sorted_keys >> rank_bits).to(torch.int32)
    sorted_orig = torch.clamp(torch.div(sorted_flat, m, rounding_mode="floor"), max=c - 1)
    tile_offsets = torch.searchsorted(
        sorted_tile,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=device),
        side="left", out_int32=True,
    )
    return Binning(
        order=order,
        isect_orig=sorted_orig,
        isect_flat=sorted_flat,
        isect_tile=sorted_tile,
        tile_offsets=tile_offsets,
        num_isects=tile_offsets[num_tiles],
        counts=counts,
        num_overflow=num_overflow,
        n_gt=n_gt,
        dense=dense,
        in_ov=in_ov_out,
        ov_rank=ov_rank_out,
    )


def _bin_binkeys(
    *, c, m, ts, tx_n, num_tiles, b_small, two_pop, rank_bits, valid, rank, mx, my,
    tx0, ty0, w, count, in_ov, ov_id, conics, opacities,
):
    """Both populations' keys, flats and counts from one ``binkeys``
    launch: the sort domain's keys and flats, and the counts."""
    device = mx.device
    fgeo = torch.stack(
        [mx, my, conics[:, 0], conics[:, 1], conics[:, 2], _s_max(opacities)]
    )
    # live in population A, or dead (an invalid row's count is 0 too); the
    # overflow rows are the tail's, each named by one slot of ov_id
    pop = valid.to(torch.int32)
    if two_pop:
        pop = torch.where(in_ov, binkeys_kernel.POP_TAIL, pop)
    arange_c = torch.arange(c, dtype=torch.int32, device=device)
    igeo = torch.stack([tx0, ty0, w, count, rank.to(torch.int32), arange_c, pop])
    return binkeys_kernel.binkeys(
        fgeo, igeo, n_keys=b_small if two_pop else m, m=m, ts=ts, tiles_x=tx_n,
        num_tiles=num_tiles, rank_bits=rank_bits, sentinel_flat=c * m,
        tail=ov_id if two_pop else None,
    )


def pack_features(
    g9: torch.Tensor,  # [C, 9] = [means2d | conics | colors | opacity]
    binning: Binning,
    geom: TiledGeometry,
) -> torch.Tensor:
    """Per-intersection feature rows [I, 16] with the quadratic form as a
    polynomial in tile-local pixel coordinates (columns 0-5, against the
    basis columns px^2, py^2, px*py, px, py, 1) and -log(opacity) in
    column 6 (basis column 6 is 1), so s2 = sigma - log(opacity)."""
    tiles = torch.clamp(binning.isect_tile, max=geom.num_tiles - 1)
    ox = (tiles % geom.tiles_x).to(torch.float32) * geom.tile_size
    oy = torch.div(tiles, geom.tiles_x, rounding_mode="floor").to(torch.float32) * geom.tile_size

    gi = g9[binning.isect_orig]  # [I, 9]
    invalid = binning.isect_tile >= geom.num_tiles
    opa = torch.where(invalid, torch.zeros_like(gi[:, 8]), gi[:, 8])

    mx = gi[:, 0] - ox  # tile-local mean
    my = gi[:, 1] - oy
    a, b, cc = gi[:, 2], gi[:, 3], gi[:, 4]
    nlopac = -torch.log(torch.clamp(opa, min=1e-12))
    return torch.stack(
        [
            0.5 * a,  # 0: * px^2
            0.5 * cc,  # 1: * py^2
            b,  # 2: * px*py
            -(a * mx + b * my),  # 3: * px
            -(cc * my + b * mx),  # 4: * py
            0.5 * a * mx * mx + 0.5 * cc * my * my + b * mx * my,  # 5: * 1
            nlopac,  # 6: -log(opacity) (basis column 6 = 1)
            mx,  # 7: payload (basis column 7 = 0)
            gi[:, 5],  # 8-10: rgb
            gi[:, 6],
            gi[:, 7],
            a,  # 11-13: conic
            b,
            cc,
            my,  # 14
            torch.zeros_like(mx),  # 15
        ],
        dim=1,
    )


def tile_pixel_basis(geom: TiledGeometry, device=None) -> torch.Tensor:
    """[P_tile, 8] polynomial basis over tile-local pixel centers, row-major:
    columns (px^2, py^2, px*py, px, py, 1, 1, 0)."""
    ts = geom.tile_size
    c = torch.arange(ts, dtype=torch.float32, device=device) + 0.5
    pyg, pxg = torch.meshgrid(c, c, indexing="ij")
    px, py = pxg.reshape(-1), pyg.reshape(-1)
    ones, zeros = torch.ones_like(px), torch.zeros_like(px)
    return torch.stack(
        [px * px, py * py, px * py, px, py, ones, ones, zeros], dim=1
    ).contiguous()


def tiles_to_image(tile_data: torch.Tensor, geom: TiledGeometry, height: int, width: int):
    """[T, ts*ts, ...] -> [H, W, ...] (crop padding)."""
    ts = geom.tile_size
    x = tile_data.reshape((geom.tiles_y, geom.tiles_x, ts, ts) + tuple(tile_data.shape[2:]))
    x = x.transpose(1, 2)
    x = x.reshape((geom.tiles_y * ts, geom.tiles_x * ts) + tuple(tile_data.shape[2:]))
    return x[:height, :width]


def image_to_tiles(img: torch.Tensor, geom: TiledGeometry, height: int, width: int):
    """[H, W, ...] -> [T, ts*ts, ...] (zero-pad to the tile grid)."""
    ts = geom.tile_size
    rest = tuple(img.shape[2:])
    x = img.new_zeros((geom.tiles_y * ts, geom.tiles_x * ts) + rest)
    x[:height, :width] = img
    x = x.reshape((geom.tiles_y, ts, geom.tiles_x, ts) + rest).transpose(1, 2)
    return x.reshape((geom.num_tiles, ts * ts) + rest)


def _ov_capacity(c: int, ov_frac: float) -> int:
    cap = max(int(c * ov_frac), 128)
    cap = -(-cap // 256) * 256
    return min(c, cap)


def _prepare(
    means2d, conics, colors, opacities, radii, depths,
    height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
    ov_frac: float = 0.125, small_budget: int = SMALL_BUDGET, y_limit=None,
):
    geom = image_geometry(height, width, tile_size)
    extents = binning_extents(conics, opacities, radii)
    # no limit given: the whole window, which excludes only gaussians
    # entirely below it (the exact tile test drops those anyway)
    binning = bin_gaussians(
        means2d, extents, depths, geom, max_tiles_w, max_tiles_h,
        conics=conics, opacities=opacities,
        ov_capacity=_ov_capacity(means2d.shape[0], ov_frac),
        small_budget=small_budget, y_limit=height if y_limit is None else y_limit,
    )
    # the sort domain can be smaller than a large requested cap; the dense
    # side channel stays at full length (the backward's inverse permutation
    # needs every sort-domain entry)
    isect_cap = min(isect_cap, binning.isect_flat.shape[0])
    sliced = binning._replace(
        isect_orig=binning.isect_orig[:isect_cap],
        isect_flat=binning.isect_flat[:isect_cap],
        isect_tile=binning.isect_tile[:isect_cap],
        tile_offsets=torch.clamp(binning.tile_offsets, max=isect_cap),
    )
    g9 = torch.cat([means2d, conics, colors, opacities[:, None]], dim=1)
    return geom, sliced, pack_features(g9, sliced, geom)


def _tiled_impl(
    means2d, conics, colors, opacities, radii, depths,
    height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
    ov_frac=0.125, small_budget=SMALL_BUDGET, y_limit=None,
):
    geom, binning, feats = _prepare(
        means2d, conics, colors, opacities, radii, depths,
        height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
        ov_frac=ov_frac, small_budget=small_budget, y_limit=y_limit,
    )
    basis = tile_pixel_basis(geom, means2d.device)
    rgb_t, tfin_t, last_t = tile_raster.tiled_forward(feats, binning.tile_offsets, basis)
    img = tiles_to_image(rgb_t, geom, height, width)
    final_t = tiles_to_image(tfin_t, geom, height, width)
    return img, final_t, (binning, feats, tfin_t, last_t)


# ------------------------------------------------------------- reductions
# Each turns the per-intersection gradient rows [I, 16] (one per capacity
# slot; rows past the last tile's range are zero, as ``tiled_backward``
# writes them) into per-Gaussian rows [C, 11]. Exact when every live
# intersection fits the capacity; on a truncated step the gradient is zero
# (the trainer's watchdog grows the capacity: one lost step, never a
# corrupted one).
def _flat_sorted(rows, isect_flat, c: int, m: int):
    """A stable sort of (flat id, position) groups each Gaussian's <= m rows
    in flat order, dead rows (flat id C*m) last; one row gather into that
    order. Each dead row gets a group id of its own (past the Gaussians'),
    so no kernel walks the dead tail as one group."""
    icap = isect_flat.shape[0]
    flat_sorted, perm = torch.sort(isect_flat, stable=True)
    dead_ids = c + torch.arange(icap, dtype=flat_sorted.dtype, device=flat_sorted.device)
    g = torch.where(
        flat_sorted < c * m, torch.div(flat_sorted, m, rounding_mode="floor"), dead_ids
    ).to(torch.int32)
    return rows[perm], g


def _gather_starts(sums, counts, num_isects) -> torch.Tensor:
    """Each Gaussian's row at its group's start (exclusive cumsum of the
    binning's live counts), zero where it has none or the step truncated."""
    icap = sums.shape[0]
    counts = counts.to(torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    have = (counts > 0) & (num_isects <= icap)
    dsum = sums[torch.clamp(starts, max=icap - 1), : tile_raster.NUM_LIVE_GRADS]
    return torch.where(have[:, None], dsum, torch.zeros_like(dsum))


def _reduce_band(rows, isect_flat, counts, num_isects, m: int) -> torch.Tensor:
    """Flat sort, the ``segsum_band`` kernel (each group's sum on its first
    row; groups of at most ``segments.LOOK`` rows), the starts gather."""
    grouped, g = _flat_sorted(rows, isect_flat, counts.shape[0], m)
    return _gather_starts(segments.segsum_band(grouped, g), counts, num_isects)


def _reduce_scan(rows, isect_flat, counts, num_isects, m: int) -> torch.Tensor:
    """Flat sort, a log-step segmented suffix scan over ceil(log2 m) shifts
    in plain tensor ops (the JAX package's XLA scan, ``rasterize_tiled.py:
    1059-1101``), the starts gather. JAX keeps two layouts of the scan, for
    XLA's fusion and its bf16 hi/lo lanes; with f32 [I, 16] rows they are
    one."""
    grouped, g = _flat_sorted(rows, isect_flat, counts.shape[0], m)
    sums = segments.segsum_band_plain(grouped, g, look=m)
    return _gather_starts(sums, counts, num_isects)


def _reduce_pallas(rows, isect_flat, counts, num_isects, m: int) -> torch.Tensor:
    """Flat sort, the ``segsum_compact`` kernel (one row per present group in
    ascending id order: the Gaussians with live rows, then the dead rows,
    which ``max_groups = C + 1`` cuts off after the first), then the
    ``monotone_expand`` kernel back to one row per Gaussian, at its rank
    among the present ones."""
    c, icap = counts.shape[0], rows.shape[0]
    grouped, g = _flat_sorted(rows, isect_flat, c, m)
    compact = segments.segsum_compact(grouped, g, max_groups=c + 1)
    present = counts > 0
    present_i = present.to(torch.int32)
    rank = torch.cumsum(present_i, 0, dtype=torch.int32) - present_i
    dsum = segments.monotone_expand(compact, rank, present)[:, : tile_raster.NUM_LIVE_GRADS]
    return torch.where(num_isects <= icap, dsum, torch.zeros_like(dsum))


def _reduce_dense(
    rows, dense, in_ov, ov_rank, num_isects, c: int, m: int, ov_cap: int
) -> torch.Tensor:
    """Rows moved into the dense duplicate grid, where each Gaussian's rows
    sit at a fixed stride, and summed there by the ``group_reduce`` kernel
    (``rasterize_tiled.py:880-946``):

    1. ``q``, the inverse of the binning's dense permutation, is one
       scatter of ``arange`` (JAX sorts ``(dense, iota)`` for it);
    2. one row gather into dense-slot order; slots at sorted positions past
       the capacity read zero (they are dead, or the step truncated);
    3. one ``group_reduce`` over population A (``b_small`` rows per
       Gaussian) and population B (M rows per slot), B's sums folded into
       their Gaussians by a gather at ``ov_rank``; one population: M rows
       per Gaussian."""
    icap, d_total = rows.shape[0], dense.shape[0]
    q = torch.empty_like(dense).scatter_(
        0, dense, torch.arange(d_total, dtype=dense.dtype, device=dense.device)
    )
    grid = rows[torch.clamp(q, max=icap - 1)]
    grid.masked_fill_((q >= icap)[:, None], 0.0)
    del q
    if in_ov is not None:
        b_eff = (d_total - ov_cap * m) // c
        sums = group_reduce_kernel.group_reduce(grid, b_eff, tail=(m, ov_cap))
        dsum, ov_sum = sums[:c], sums[c:]
        fold = ov_sum[torch.clamp(ov_rank, max=ov_cap - 1).to(torch.int64)]
        dsum = dsum + torch.where(in_ov[:, None], fold, torch.zeros_like(fold))
    else:
        dsum = group_reduce_kernel.group_reduce(grid, m)
    dsum = dsum[:, : tile_raster.NUM_LIVE_GRADS]
    return torch.where(num_isects <= icap, dsum, torch.zeros_like(dsum))


class _RasterizeTiledCore(torch.autograd.Function):
    """The tiled rasterizer with its hand-written gradient. Inputs
    means2d, conics, colors, opacities and absgrad_dummy get gradients;
    radii, depths and y_limit (binning only) get none."""

    @staticmethod
    def forward(
        ctx, means2d, conics, colors, opacities, radii, depths, absgrad_dummy,
        y_limit, height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
        ov_frac, small_budget,
    ):
        reduce = _bwd_reduce()
        img, final_t, (binning, feats, tfin_t, last_t) = _tiled_impl(
            means2d, conics, colors, opacities, radii, depths,
            height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
            ov_frac, small_budget, y_limit,
        )
        ctx.save_for_backward(
            feats, tfin_t, last_t, binning.tile_offsets, binning.isect_flat,
            binning.counts, binning.num_isects, binning.dense, binning.in_ov,
            binning.ov_rank,
        )
        m = max_tiles_w * max_tiles_h
        if reduce == "band" and m > segments.LOOK:
            reduce = "scan"  # groups longer than the band kernel's lookahead
        ctx.reduce = reduce
        ctx.dims = (height, width, tile_size, m, _ov_capacity(means2d.shape[0], ov_frac))
        ctx.mark_non_differentiable(binning.num_isects)
        return img, final_t, binning.num_isects

    @staticmethod
    def backward(ctx, g_img, g_t, _g_n):
        (feats, tfin_t, last_t, tile_offsets, isect_flat, counts, num_isects,
         dense, in_ov, ov_rank) = ctx.saved_tensors
        height, width, tile_size, m, ov_cap = ctx.dims
        geom = image_geometry(height, width, tile_size)
        basis = tile_pixel_basis(geom, feats.device)
        rows = tile_raster.tiled_backward(
            feats, tile_offsets, basis,
            image_to_tiles(g_img.contiguous(), geom, height, width).contiguous(),
            image_to_tiles(g_t.contiguous(), geom, height, width).contiguous(),
            tfin_t, last_t,
        )
        if ctx.reduce == "dense":
            dsum = _reduce_dense(
                rows, dense, in_ov, ov_rank, num_isects, counts.shape[0], m, ov_cap
            )
        else:
            reduce_fn = {"band": _reduce_band, "scan": _reduce_scan, "pallas": _reduce_pallas}
            dsum = reduce_fn[ctx.reduce](rows, isect_flat, counts, num_isects, m)
        v_abs = dsum[:, 9:11] if ctx.needs_input_grad[6] else None
        return (
            dsum[:, 0:2], dsum[:, 2:5], dsum[:, 6:9], dsum[:, 5], None, None, v_abs,
            None, None, None, None, None, None, None, None, None,
        )


def rasterize_tiled(
    means2d, conics, colors, opacities, depths, background, absgrad_dummy,
    height, width, *, radii,
    tile_size: int = DEFAULT_TILE,
    max_tiles_w: int = DEFAULT_MAX_TILES_W,
    max_tiles_h: int = DEFAULT_MAX_TILES_H,
    isect_mult: float = 3,
    return_isects: bool = False,
    ov_frac: float = 0.125,
    small_budget: int = SMALL_BUDGET,
    y_limit: torch.Tensor | None = None,  # 0-d f32 rows: bin only rows
    # [0, y_limit) of the window (default its height)
):
    """Tiled rasterization with the unified rasterizer signature (see
    ``models/render.py``). Returns (image [H,W,3], alpha [H,W]), plus the
    binned intersection count (a device scalar) when ``return_isects``;
    intersections beyond ``isect_capacity(C, isect_mult)`` are dropped,
    and then the step's gradient is zero. The gradient of
    ``absgrad_dummy`` ([C, 2] zeros, or None) is the absgrad side channel.
    The background blend stays outside the custom gradient, so autograd
    carries its gradient into the final transmittance."""
    if tile_size * tile_size > tile_raster.MAX_TILE_PIXELS:
        raise ValueError(f"tile_size {tile_size} > 32: one thread per tile pixel")
    isect_cap = isect_capacity(means2d.shape[0], isect_mult)
    # zero-opacity gaussians (dead capacity slots, culls) are never binned
    radii = torch.where(opacities > 0.0, radii, torch.zeros_like(radii))
    img, final_t, num_isects = _RasterizeTiledCore.apply(
        means2d, conics, colors, opacities, radii, depths, absgrad_dummy,
        y_limit, height, width, tile_size, max_tiles_w, max_tiles_h, isect_cap,
        ov_frac, small_budget,
    )
    img = img + final_t[..., None] * background[None, None, :]
    if return_isects:
        return img, 1.0 - final_t, num_isects
    return img, 1.0 - final_t


def make_isect_counter(
    tile_size: int = DEFAULT_TILE,
    max_tiles_w: int = DEFAULT_MAX_TILES_W,
    max_tiles_h: int = DEFAULT_MAX_TILES_H,
    ov_frac: float = 0.125,
    small_budget: int = SMALL_BUDGET,
):
    """(params, alive, w2c, K, *, height, width) -> i32 [2 +
    len(BUDGET_CANDIDATES)]: [num_isects, num_overflow, *n_gt], the
    binning statistics the capacity autotune reads."""

    def count(params, alive, w2c, K, *, height, width):
        scales = torch.exp(params.log_scales)
        opac = torch.sigmoid(params.logit_opacities) * alive.to(torch.float32)
        intr = CameraIntrinsics.from_K(K, width, height)
        proj = project_gaussians(params.means, params.quats, scales, w2c, intr)
        radii = torch.where(opac > 0.0, proj.radii, torch.zeros_like(proj.radii))
        geom = image_geometry(height, width, tile_size)
        extents = binning_extents(proj.conics, opac, radii)
        binning = bin_gaussians(
            proj.means2d, extents, proj.depths, geom, max_tiles_w, max_tiles_h,
            conics=proj.conics, opacities=opac,
            ov_capacity=_ov_capacity(params.means.shape[0], ov_frac),
            small_budget=small_budget, y_limit=float(height),
        )
        return torch.cat(
            [torch.stack([binning.num_isects, binning.num_overflow]), binning.n_gt]
        )

    return count


def make_tiled_render_fn(
    tile_size: int = DEFAULT_TILE,
    max_tiles_w: int = DEFAULT_MAX_TILES_W,
    max_tiles_h: int = DEFAULT_MAX_TILES_H,
    isect_mult: float = 3,
    ov_frac: float = 0.125,
    small_budget: int = SMALL_BUDGET,
):
    """Render function (``models/render.py`` signature) over the tiled
    rasterizer."""
    from ..models.render import render as _render

    rasterizer = functools.partial(
        rasterize_tiled,
        tile_size=tile_size,
        max_tiles_w=max_tiles_w,
        max_tiles_h=max_tiles_h,
        isect_mult=isect_mult,
        return_isects=True,
        ov_frac=ov_frac,
        small_budget=small_budget,
    )
    return functools.partial(_render, rasterizer=rasterizer)
