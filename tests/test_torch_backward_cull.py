"""Host-side pieces of the tile kernels' per-warp cull, on the CPU: their
warps' pixel layout and the plain version of the cull, which must never
drop a feature row that some pixel of the warp finds eligible. On the card
(marker ``cuda``; it skips without one), the cull of each kernel:

    python -m pytest tests/test_torch_backward_cull.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr


@pytest.mark.parametrize("p,side", [(64, 8), (144, 0), (256, 16), (576, 24), (1024, 32), (100, 0)])
def test_warp_block_side(p, side):
    assert tr.warp_block_side(p) == side


@pytest.mark.parametrize("tile_size", [8, 12, 16, 24, 32])
def test_warp_pixels_cover_the_tile(tile_size):
    """Every pixel in exactly one slot; an 8x8 block per warp when the side
    is a multiple of 8, else 64 consecutive pixels and an empty tail."""
    p = tile_size * tile_size
    layout = tr.warp_pixels(p)
    assert layout.shape == (-(-p // 64), 64)
    live = layout[layout < p]
    assert torch.equal(torch.sort(live).values, torch.arange(p))
    assert (layout[layout >= p] == p).all()
    x, y = layout % tile_size, layout // tile_size
    if tile_size % 8 == 0:
        assert ((x.amax(1) - x.amin(1)) == 7).all() and ((y.amax(1) - y.amin(1)) == 7).all()
        # lane l holds pixels (l % 8, l // 8) and (l % 8, l // 8 + 4) of its block
        assert torch.equal(layout[:, 32:] - layout[:, :32], torch.full((layout.shape[0], 32), 4 * tile_size))
    else:
        assert torch.equal(layout.flatten()[:p], torch.arange(p))


def _conics(rng, n, scale):
    """[n, 3] conics (a, b, c) of random covariances of ``scale`` [n] px."""
    L = rng.normal(size=(n, 2, 2)) * scale[:, None, None]
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 0.3
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] ** 2
    return np.stack([cov[:, 1, 1] / det, -cov[:, 0, 1] / det, cov[:, 0, 0] / det], -1)


def _random_gaussians(rng, n, tile_size):
    """[n, 9] (mean, conic, rgb, opacity) of Gaussians of mixed size, shape
    and opacity around a tile at the origin."""
    m2d = rng.uniform(-12, tile_size + 12, size=(n, 2))
    con = _conics(rng, n, rng.uniform(0.2, 6.0, size=n))
    opa = rng.uniform(0.005, 1.0, size=n)
    return np.concatenate([m2d, con, rng.uniform(size=(n, 3)), opa[:, None]], 1)


EDGES = (float(np.log(255.0)), tr.S2_REACH)  # eligibility's edge, the cull's reach


def _edge_gaussians(rng, n, tile_size):
    """[n, 9] Gaussians placed so that their smallest s2 (sigma plus
    -log(opacity)) over the pixel centres of one warp of the backward
    kernel sits at an edge, within a relative 1e-4 (eligibility's, where
    one pixel of the warp may just composite the row, or the cull's reach):
    found in float64 by bisection along a random ray from the warp's
    centre. Sizes up to 60 px put some means hundreds of px off the tile."""
    p = tile_size * tile_size
    layout = tr.warp_pixels(p).numpy()
    pix = layout[rng.integers(0, layout.shape[0], size=n)]  # [n, 64], p: no pixel
    safe = np.minimum(pix, p - 1)
    wx = np.where(pix < p, safe % tile_size + 0.5, np.nan)
    wy = np.where(pix < p, safe // tile_size + 0.5, np.nan)
    con = _conics(rng, n, np.exp(rng.uniform(np.log(0.3), np.log(60.0), size=n)))
    opa = rng.uniform(0.05, 1.0, size=n)
    edge = np.asarray(EDGES)[rng.integers(0, 2, size=n)]
    want = edge * (1.0 + rng.choice([-1e-4, -1e-6, 0.0, 1e-6, 1e-4], size=n)) + np.log(opa)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=n)
    ux, uy = np.cos(theta), np.sin(theta)
    cx, cy = np.nanmean(wx, 1), np.nanmean(wy, 1)

    def smallest_sigma(r):
        dx, dy = wx - (cx + r * ux)[:, None], wy - (cy + r * uy)[:, None]
        a, b, c = (con[:, k, None] for k in range(3))
        return np.nanmin(0.5 * a * dx * dx + b * dx * dy + 0.5 * c * dy * dy, 1)

    lo, hi = np.zeros(n), np.ones(n)
    while (grow := smallest_sigma(hi) < want).any():
        hi = np.where(grow, 2.0 * hi, hi)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = smallest_sigma(mid) < want
        lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
    m2d = np.stack([cx + hi * ux, cy + hi * uy], 1)
    return np.concatenate([m2d, con, rng.uniform(size=(n, 3)), opa[:, None]], 1)


def _pack(g9, tile_size):
    """Feature rows of one tile at the origin, as ``pack_features`` makes
    them, and the tile's pixel basis."""
    n = g9.shape[0]
    geom = trt.image_geometry(tile_size, tile_size, tile_size)
    binning = trt.Binning(*[None] * len(trt.Binning._fields))._replace(
        isect_tile=torch.zeros(n, dtype=torch.int32), isect_orig=torch.arange(n))
    rows = trt.pack_features(torch.as_tensor(g9, dtype=torch.float32), binning, geom)
    return rows, trt.tile_pixel_basis(geom)


def _rows(rng, n, tile_size):
    return _pack(_random_gaussians(rng, n, tile_size), tile_size)


def _rect(basis, pix):
    """The bounding box (x0, x1, y0, y1) of the pixel centres ``pix``."""
    return basis[pix, 3].min(), basis[pix, 3].max(), basis[pix, 4].min(), basis[pix, 4].max()


@pytest.mark.parametrize("tile_size", [8, 12, 16, 32])
@pytest.mark.parametrize("kind", ["random", "edge"])
def test_warp_reach_keeps_every_reachable_row(kind, tile_size):
    """For each warp of the kernel's layout: every row with s2 <= S2_REACH
    at one of the warp's pixels (the kernels' own rounding, ``_sigma2``) is
    kept; on Gaussians placed at the edges of eligibility and of the cull's
    reach for one warp, and on Gaussians around the tile, where most rows
    that reach none of a warp's pixels are dropped."""
    rng = np.random.default_rng(tile_size)
    make = _random_gaussians if kind == "random" else _edge_gaussians
    rows, basis = _pack(make(rng, 4000, tile_size), tile_size)
    s2 = tr._sigma2(rows[None], basis)[0]  # [P, R]
    p = basis.shape[0]
    dropped = unreachable = 0
    for pix in tr.warp_pixels(p):
        pix = pix[pix < p]
        kept = tr.warp_reach_plain(rows, _rect(basis, pix))
        reach = (s2[pix] <= tr.S2_REACH).any(0)
        assert not (reach & ~kept).any(), "the cull dropped a reachable row"
        dropped += int((~kept).sum())
        unreachable += int((~reach).sum())
    assert kind == "edge" or dropped > 0.5 * unreachable


def _edge_tile(tile_size, dev):
    """One tile of rows placed at the edges of eligibility and of the cull's
    reach for one warp (some with means far off the tile) among ordinary
    rows, on the card: (feats, offsets, basis). Checks that the cull has
    work at both edges."""
    rng = np.random.default_rng(100 + tile_size)
    g9 = np.concatenate([_edge_gaussians(rng, 3000, tile_size), _random_gaussians(rng, 1000, tile_size)])
    rows, basis = _pack(g9[rng.permutation(g9.shape[0])], tile_size)
    p, n = basis.shape[0], rows.shape[0]
    s2 = tr._sigma2(rows[None], basis)[0]
    culled = composited_at_edge = 0
    for pix in tr.warp_pixels(p):
        pix = pix[pix < p]
        culled += int((~tr.warp_reach_plain(rows, _rect(basis, pix))).sum())
        eligible = (s2[pix] <= EDGES[0]).sum(0)
        composited_at_edge += int(((eligible > 0) & (eligible < 4)).sum())
    assert culled > n // 2 and composited_at_edge > 100  # the cull has work at both edges
    return rows.to(dev), torch.tensor([0, n], dtype=torch.int32, device=dev), basis.to(dev)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [12, 16, 32])
def test_kernel_cull_is_exact(monkeypatch, tile_size):
    """On the card, the backward on the edge tile (``_edge_tile``): the
    kernel gives the same bits with its cull as with the cull disabled
    (``CULL_DET_MIN`` = inf keeps every row), so the cull dropped no row that
    a pixel composites; and it agrees with the plain version within 1e-4 of
    each column's largest magnitude."""
    dev = _card()
    feats, offs, basis = _edge_tile(tile_size, dev)
    p = basis.shape[0]
    _, t_fin, last = tr.tiled_forward(feats, offs, basis)
    gen = torch.Generator(device=dev).manual_seed(0)
    args = (feats, offs, basis, torch.randn((1, p, 3), generator=gen, device=dev),
            torch.randn((1, p), generator=gen, device=dev), t_fin, last)
    got = tr.tiled_backward(*args)
    want = tr.tiled_backward_plain(*args)
    monkeypatch.setattr(tr, "CULL_DET_MIN", float("inf"))
    uncut = tr.tiled_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, uncut)
    scale = want.abs().amax(dim=0)
    err = (got - want).abs().amax(dim=0)
    assert (err[:11] <= 1e-4 * scale[:11]).all(), (err / scale.clamp(min=1e-30)).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [12, 16, 32])
def test_kernel_forward_cull_is_exact(monkeypatch, tile_size):
    """On the card, the forward on the edge tile (``_edge_tile``): rgb, final
    T and last are the same bits with the cull as with it disabled, so the
    cull dropped no row that a pixel composites or that stops a pixel; and
    the kernel agrees with the plain version within 1e-4 on 98% of the
    pixels (a tile of 144 pixels or more: the plain version's cumulative
    product rounds in another order, which can flip a stop decision where T
    lands on 1e-4)."""
    dev = _card()
    feats, offs, basis = _edge_tile(tile_size, dev)
    got = tr.tiled_forward(feats, offs, basis)
    want = tr.tiled_forward_plain(feats, offs, basis)
    monkeypatch.setattr(tr, "CULL_DET_MIN", float("inf"))
    uncut = tr.tiled_forward(feats, offs, basis)
    torch.cuda.synchronize()
    for g, u in zip(got, uncut):
        assert torch.equal(g, u)
    rgb, t_fin, last = got
    assert (last >= 0).all() and (t_fin < 1.0).all()  # every pixel composites
    ok = ((rgb - want[0]).abs().amax(-1) <= 1e-4) & ((t_fin - want[1]).abs() <= 1e-4)
    assert ok.float().mean().item() >= 0.98


@pytest.mark.parametrize("tile_size", [12, 16, 32])
@pytest.mark.parametrize("kind", ["random", "edge"])
def test_tile_bound_reach_keeps_every_reachable_row(kind, tile_size):
    """The forward kernel's cull: one box of each row for all of a tile's
    warps, under the tile's bound on |px| and |py|. For each warp it keeps
    every row with s2 <= S2_REACH at one of the warp's pixels, and every row
    the cull under the warp's own bound keeps (a larger bound only widens
    the box)."""
    rng = np.random.default_rng(50 + tile_size)
    make = _random_gaussians if kind == "random" else _edge_gaussians
    rows, basis = _pack(make(rng, 3000, tile_size), tile_size)
    s2 = tr._sigma2(rows[None], basis)[0]  # [P, R]
    p = basis.shape[0]
    bound = (float(basis[:, 3].abs().max()), float(basis[:, 4].abs().max()))
    dropped = 0
    for pix in tr.warp_pixels(p):
        pix = pix[pix < p]
        keep = tr.warp_reach_plain(rows, _rect(basis, pix), bound)
        reach = (s2[pix] <= tr.S2_REACH).any(0)
        assert not (reach & ~keep).any(), "the cull dropped a reachable row"
        assert not (tr.warp_reach_plain(rows, _rect(basis, pix)) & ~keep).any()
        dropped += int((~keep).sum())
    assert kind == "edge" or dropped > 0


def test_warp_reach_keeps_rows_it_cannot_bound():
    """A polynomial that is not the row's conic form, a conic that is not
    positive definite, or a value that is not finite: kept."""
    rng = np.random.default_rng(1)
    rows, _ = _rows(rng, 64, 16)
    far = (100.0, 107.0, 100.0, 107.0)  # no row reaches this box
    assert not tr.warp_reach_plain(rows, far).any()
    for col, value in ((3, 1.0), (5, -2.0), (13, -1.0), (11, float("nan")), (7, float("inf"))):
        bad = rows.clone()
        bad[:, col] = value if col != 3 else bad[:, col] + value
        assert tr.warp_reach_plain(bad, far).all(), col
