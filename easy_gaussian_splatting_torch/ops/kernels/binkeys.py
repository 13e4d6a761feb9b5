"""Binning keys for both Gaussian populations: the CUDA kernel
``csrc/binkeys.cu`` and its plain PyTorch version.

Counterpart of ``easy_gaussian_splatting_tpu/ops/pallas/binkeys.py``, which
the JAX package calls once per population. The inputs are
structure-of-arrays rows of decoded values, not the TPU's feature-major f32
encoding:

  fgeo [6, n] f32   mx, my, a, b, c, s_max
  igeo [7, n] i32   tx0, ty0, w, count, rank, orig, pop

Population a is every row's first ``n_keys`` window cells, its keys live
where ``pop`` is 1 (0: dead; 2: the row belongs to the tail). The tail
(population b) is ``tail`` [n_tail] i64, row ids of ``fgeo``/``igeo`` (an
id of n or more is an empty slot), each with all ``m`` cells, its keys live
where the slot is not empty. Outputs: the sort domain's keys ``(tile <<
rank_bits) | rank`` i64 (tile ``num_tiles`` when dead) and flats ``orig * m
+ j`` i32 (``sentinel_flat`` when dead), population a's [n_keys, n]
cell-major then the tail's [m, n_tail]; counts [n] i32, each row's live
cells among its first ``n_keys``, or among all ``m`` for a row of the tail.
Every row whose ``pop`` is 2 must be named by exactly one slot of the tail.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

FGEO_ROWS = ("mx", "my", "a", "b", "c", "s_max")
IGEO_ROWS = ("tx0", "ty0", "w", "count", "rank", "orig", "pop")
# igeo's `pop`: 1 live in population a, 2 a row of the tail (0: dead)
POP_A, POP_TAIL = 1, 2

# kernel launches made by `binkeys` (the plain version never counts)
launches = 0


def tile_sigma_min(x0, y0, ts: int, a, b, cc) -> torch.Tensor:
    """Minimum of the quadratic form sigma(d) = a/2 dx^2 + c/2 dy^2 + b dx dy
    over each tile's pixel rectangle [x0, x0 + ts] x [y0, y0 + ts] (corners
    relative to the mean): 0 when the mean lies inside, else the least of
    the four clamped edge minima. Shared by the plain ``binkeys`` and the
    grid binning, in the JAX package's term order
    (``rasterize_tiled.py:460-488``), so both binnings drop the same cells
    and the kernel, built without FMA contraction, rounds the same way."""
    x1 = x0 + ts
    y1 = y0 + ts
    a_safe = torch.clamp(a, min=1e-12)
    c_safe = torch.clamp(cc, min=1e-12)

    def sig(dx, dy):
        return 0.5 * a * dx * dx + 0.5 * cc * dy * dy + b * dx * dy

    def edge_x(xe):
        return sig(xe, torch.clamp(-b * xe / c_safe, min=y0, max=y1))

    def edge_y(ye):
        return sig(torch.clamp(-b * ye / a_safe, min=x0, max=x1), ye)

    s_edge = torch.minimum(
        torch.minimum(edge_x(x0), edge_x(x1)),
        torch.minimum(edge_y(y0), edge_y(y1)),
    )
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    return torch.where(inside, torch.zeros_like(s_edge), s_edge)


def population_plain(
    fgeo: torch.Tensor, igeo: torch.Tensor, *, n_keys: int, m: int, ts: int,
    tiles_x: int, num_tiles: int, rank_bits: int, sentinel_flat: int,
):
    """One population, as the JAX kernel computes it, with a [m, n] PyTorch
    grid in the expression order of the JAX package's XLA grid
    (``rasterize_tiled.py:438-498``); igeo's last row is ``livebase`` (keys
    live where it is set). Returns keys and flats [n_keys, n], count_small
    (live cells among the first n_keys) and count_full (among all m)."""
    mx, my, a, b, cc, s_max = fgeo
    tx0, ty0, w, count, rank, orig, livebase = igeo
    j = torch.arange(m, dtype=torch.int32, device=fgeo.device)[:, None]
    w_safe = torch.clamp(w, min=1)[None, :]
    jy = torch.div(j, w_safe, rounding_mode="floor")
    jx = j - jy * w_safe

    x0 = ((tx0 + jx) * ts).to(torch.float32) - mx
    y0 = ((ty0 + jy) * ts).to(torch.float32) - my
    s_min = tile_sigma_min(x0, y0, ts, a, b, cc)
    live = (j < count) & (s_min <= s_max)

    count_full = live.sum(dim=0, dtype=torch.int32)
    count_small = live[:n_keys].sum(dim=0, dtype=torch.int32)
    key_live = live[:n_keys] & (livebase != 0)
    tile = ((ty0 + jy[:n_keys]) * tiles_x + tx0 + jx[:n_keys]).to(torch.int64)
    rank64 = rank.to(torch.int64)
    keys = torch.where(
        key_live, (tile << rank_bits) | rank64, (num_tiles << rank_bits) | rank64
    )
    flats = torch.where(
        key_live, orig * m + j[:n_keys],
        torch.full_like(key_live, sentinel_flat, dtype=torch.int32),
    ).to(torch.int32)
    return keys, flats, count_small, count_full


def binkeys_plain(
    fgeo: torch.Tensor, igeo: torch.Tensor, *, n_keys: int, m: int, ts: int,
    tiles_x: int, num_tiles: int, rank_bits: int, sentinel_flat: int,
    tail: torch.Tensor | None = None,
):
    """The kernel's function from two ``population_plain`` calls: population
    a with livebase ``pop == 1``, and the tail's rows gathered with livebase
    "the slot is not empty"."""
    kw = dict(
        m=m, ts=ts, tiles_x=tiles_x, num_tiles=num_tiles, rank_bits=rank_bits,
        sentinel_flat=sentinel_flat,
    )
    pop = igeo[6]
    igeo_a = torch.cat([igeo[:6], (pop == POP_A).to(torch.int32)[None]])
    keys, flats, count_small, count_full = population_plain(fgeo, igeo_a, n_keys=n_keys, **kw)
    counts = torch.where(pop == POP_TAIL, count_full, count_small)
    if tail is None:
        return keys.reshape(-1), flats.reshape(-1), counts
    n = fgeo.shape[1]
    row = torch.clamp(tail, max=n - 1)
    igeo_b = torch.cat([igeo[:6, row], (tail < n).to(torch.int32)[None]])
    keys_b, flats_b, _, _ = population_plain(fgeo[:, row], igeo_b, n_keys=m, **kw)
    return (torch.cat([keys.reshape(-1), keys_b.reshape(-1)]),
            torch.cat([flats.reshape(-1), flats_b.reshape(-1)]), counts)


def binkeys(
    fgeo: torch.Tensor, igeo: torch.Tensor, *, n_keys: int, m: int, ts: int,
    tiles_x: int, num_tiles: int, rank_bits: int, sentinel_flat: int,
    tail: torch.Tensor | None = None,
):
    """Binning keys of both populations in one launch; see the module
    docstring. Returns (keys, flats, counts). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    kw = dict(
        n_keys=n_keys, m=m, ts=ts, tiles_x=tiles_x, num_tiles=num_tiles,
        rank_bits=rank_bits, sentinel_flat=sentinel_flat,
    )
    if fgeo.device.type == "cpu":
        return binkeys_plain(fgeo, igeo, tail=tail, **kw)
    n = fgeo.shape[1]
    dev = fgeo.device
    if dev.type != "cuda" or igeo.device != dev or (tail is not None and tail.device != dev):
        raise ValueError(f"binkeys: unsupported devices {fgeo.device}, {igeo.device}")
    if fgeo.dtype != torch.float32 or igeo.dtype != torch.int32:
        raise ValueError(f"binkeys: want f32/i32 rows, got {fgeo.dtype}/{igeo.dtype}")
    if fgeo.shape != (len(FGEO_ROWS), n) or igeo.shape != (len(IGEO_ROWS), n):
        raise ValueError(f"binkeys: bad shapes {tuple(fgeo.shape)}, {tuple(igeo.shape)}")
    if tail is not None and (tail.dtype != torch.int64 or tail.dim() != 1):
        raise ValueError(f"binkeys: tail must be [n_tail] i64, got {tail.dtype} {tuple(tail.shape)}")
    if not (fgeo.is_contiguous() and igeo.is_contiguous()
            and (tail is None or tail.is_contiguous())):
        raise ValueError("binkeys: inputs must be contiguous")
    if not 0 < n_keys <= m or rank_bits + num_tiles.bit_length() > 63:
        raise ValueError(f"binkeys: bad n_keys={n_keys}, m={m} or key width")
    n_tail = 0 if tail is None else tail.shape[0]
    if n == 0 and n_tail:
        raise ValueError("binkeys: a tail needs rows")
    size = n_keys * n + m * n_tail
    keys = torch.empty((size,), dtype=torch.int64, device=dev)
    flats = torch.empty((size,), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return keys, flats, counts
    lib = _build.load("binkeys")
    fn = lib.egs_binkeys
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    )
    err = fn(
        fgeo.data_ptr(), igeo.data_ptr(), n, n_keys, m, ts, tiles_x,
        num_tiles, rank_bits, sentinel_flat, 0 if tail is None else tail.data_ptr(), n_tail,
        keys.data_ptr(), flats.data_ptr(), counts.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"binkeys kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return keys, flats, counts
