"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test needs an NVIDIA Hopper card and ``nvcc``; without a card
each skips with the reason. On the card (where JAX, which the suite's
conftest imports, need not be installed):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels import _build
from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
from easy_gaussian_splatting_torch.ops.kernels import segments as seg
from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _scene(rng, n, height, width, device, opacity=(0.05, 0.99), scale=(0.3, 4.0)):
    """Screen-space Gaussians of mixed size and opacity."""
    m2d = rng.uniform([-8, -8], [width + 8, height + 8], size=(n, 2))
    L = rng.normal(size=(n, 2, 2)) * rng.uniform(*scale, size=(n, 1, 1))
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 0.3
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] ** 2
    con = np.stack([cov[:, 1, 1] / det, -cov[:, 0, 1] / det, cov[:, 0, 0] / det], -1)
    b = 0.5 * (cov[:, 0, 0] + cov[:, 1, 1])
    rad = np.ceil(3.0 * np.sqrt(b + np.sqrt(np.maximum(b * b - det, 0.01))))
    col = rng.uniform(size=(n, 3))
    opa = rng.uniform(*opacity, size=n)
    dep = rng.uniform(1.0, 10.0, size=n)
    return [torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (m2d, con, col, opa, dep, rad)]


def test_build_all(cuda):
    secs = _build.build_all()
    assert set(secs) == {
        "binkeys", "tile_forward", "tile_backward", "segsum_band", "segsum_compact",
        "monotone_expand", "group_reduce", "sh_color", "adam",
    }


@pytest.mark.parametrize("small_budget", [2, 4, 9])
def test_binkeys_matches_plain(cuda, rng, small_budget):
    """Both populations of a real binning call in one launch, with overflow
    rows (a few Gaussians far larger than the rest, more of them than the
    tail has slots at the smaller budgets): keys, flats and counts are
    integers and must be equal (the library is built without FMA
    contraction, so the exact tile test rounds like the plain version)."""
    h, w = 360, 480
    small = _scene(rng, 20000, h, w, cuda)
    big = _scene(rng, 600, h, w, cuda, scale=(6.0, 20.0))
    m2d, con, col, opa, dep, rad = (torch.cat([a, b]) for a, b in zip(small, big))
    geom = trt.image_geometry(h, w, 16)
    ext = trt.binning_extents(con, opa, rad)
    calls = []
    orig = bk.binkeys

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    bk.binkeys = rec
    try:
        trt.bin_gaussians(m2d, ext, dep, geom, 4, 4, con, opa, ov_capacity=256,
                          small_budget=small_budget, y_limit=h)
    finally:
        bk.binkeys = orig
    assert len(calls) == 1
    (fgeo, igeo), kw = calls[0]
    in_tail = int((igeo[6] == bk.POP_TAIL).sum())
    assert in_tail > 0 and kw["tail"].shape[0] == 256
    assert (igeo[3] > small_budget).sum() > in_tail or small_budget == 9  # some overflow past the tail
    before = bk.launches
    for got, want in zip(bk.binkeys(fgeo, igeo, **kw), bk.binkeys_plain(fgeo, igeo, **kw)):
        assert torch.equal(got, want)
    assert bk.launches == before + 1


@pytest.mark.parametrize("opacity", [(0.05, 0.99), (0.01, 0.1)], ids=["mixed", "low"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_tiled_forward_matches_plain(cuda, rng, tile_size, opacity):
    """The per-warp walk against the plain version's cumulative products:
    1e-4 on at least 99.99% of pixels (rounding can flip a stop decision of
    a pixel whose transmittance lands on 1e-4). Mixed opacities saturate
    pixels, which stop early; opacities 0.01-0.1 saturate none, so every
    warp walks its tile's whole list, most of whose rows reach none of its
    pixels and are culled."""
    h, w = 256, 320
    m2d, con, col, opa, dep, rad = _scene(rng, 30000, h, w, cuda, opacity=opacity)
    geom, binning, feats = trt._prepare(
        m2d, con, col, opa, rad, dep, h, w, tile_size, 4, 4, isect_cap=10**7,
    )
    basis = trt.tile_pixel_basis(geom, cuda)
    before = tr.launches
    k_rgb, k_t, k_last = tr.tiled_forward(feats, binning.tile_offsets, basis)
    p_rgb, p_t, p_last = tr.tiled_forward_plain(feats, binning.tile_offsets, basis)
    torch.cuda.synchronize()
    assert tr.launches == before + 1
    ok = ((k_rgb - p_rgb).abs().amax(-1) <= 1e-4) & ((k_t - p_t).abs() <= 1e-4)
    assert ok.float().mean().item() >= 0.9999
    assert ((k_last == p_last) | ~ok).float().mean().item() >= 0.999
    if opacity[1] > 0.5:
        assert (k_t < 1e-3).any()  # some pixels saturate and stop early
    else:
        assert (k_t > 0.05).all() and (k_last >= 0).float().mean().item() > 0.9


def test_rasterize_tiled_kernels_match_plain(cuda, rng):
    """The whole tiled rasterizer on the card with the kernels, and with
    both wrappers swapped for their plain versions."""
    h, w = 200, 264
    scene = _scene(rng, 15000, h, w, cuda)
    m2d, con, col, opa, dep, rad = scene
    bg = torch.tensor([0.2, 0.3, 0.4], device=cuda)
    kw = dict(radii=rad, tile_size=32, isect_mult=6, return_isects=True)
    img, alpha, n = trt.rasterize_tiled(m2d, con, col, opa, dep, bg, None, h, w, **kw)
    orig = (bk.binkeys, tr.tiled_forward)
    bk.binkeys, tr.tiled_forward = bk.binkeys_plain, tr.tiled_forward_plain
    try:
        img_p, alpha_p, n_p = trt.rasterize_tiled(m2d, con, col, opa, dep, bg, None, h, w, **kw)
    finally:
        bk.binkeys, tr.tiled_forward = orig
    assert int(n) == int(n_p) > 0
    ok = (img - img_p).abs().amax(-1) <= 1e-4
    assert ok.float().mean().item() >= 0.9999


@pytest.mark.parametrize("tile_size", [16, 32])
def test_tiled_backward_matches_plain(cuda, rng, tile_size):
    """The back-to-front walk and per-warp reductions against the plain
    version's suffix products, on the forward kernel's own T and last:
    both replay the same eligibility test (``csrc/tile_eligibility.cuh``,
    rounded term by term), so they differ only in summation order. Stated
    bound: 1e-4 of
    each column's largest magnitude."""
    h, w = 256, 320
    m2d, con, col, opa, dep, rad = _scene(rng, 30000, h, w, cuda)
    geom, binning, feats = trt._prepare(
        m2d, con, col, opa, rad, dep, h, w, tile_size, 4, 4, isect_cap=10**7,
    )
    basis = trt.tile_pixel_basis(geom, cuda)
    _, t_fin, last = tr.tiled_forward(feats, binning.tile_offsets, basis)
    t, p = t_fin.shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_img = torch.randn((t, p, 3), generator=gen, device=cuda)
    g_t = torch.randn((t, p), generator=gen, device=cuda)
    args = (feats, binning.tile_offsets, basis, g_img, g_t, t_fin, last)
    before = tr.backward_launches
    got = tr.tiled_backward(*args)
    want = tr.tiled_backward_plain(*args)
    torch.cuda.synchronize()
    assert tr.backward_launches == before + 1
    scale = want.abs().amax(dim=0)
    assert (scale[:11] > 0).all() and (got[:, 11:] == 0).all()
    err = (got - want).abs().amax(dim=0)
    assert (err[:11] <= 1e-4 * scale[:11]).all(), (err / scale.clamp(min=1e-30)).tolist()


@pytest.mark.parametrize("tile_size", [8, 12, 16, 32])
def test_tiled_backward_low_opacity(cuda, rng, tile_size):
    """Opacities 0.01-0.1: pixels rarely saturate, so each pixel walks to
    its own last contributor and the 64-pixel warps' horizons differ from
    their tile's (tile 8 is one warp; tile 12: P = 144, no square of a
    multiple of 8, so the consecutive layout, its last warp part empty).
    Against the plain version within 1e-4 of each column's largest
    magnitude; a second launch gives the same bits; every row past a tile's
    horizon and past ``offsets[-1]`` is zero though the output is allocated
    uninitialised (its memory first filled with NaN)."""
    h, w = 192, 224
    m2d, con, col, opa, dep, rad = _scene(rng, 20000, h, w, cuda, opacity=(0.01, 0.1))
    geom, binning, feats = trt._prepare(
        m2d, con, col, opa, rad, dep, h, w, tile_size, 4, 4, isect_cap=10**6,
    )
    basis = trt.tile_pixel_basis(geom, cuda)
    offs = binning.tile_offsets
    _, t_fin, last = tr.tiled_forward(feats, offs, basis)
    t, p = t_fin.shape
    padded = torch.cat([last, torch.full((t, 1), -1, dtype=last.dtype, device=cuda)], 1)
    warp_h = padded[:, tr.warp_pixels(p).to(cuda)].amax(2)
    assert p == 64 or (warp_h < last.amax(1, keepdim=True)).any()  # tile 8: one warp
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = (feats, offs, basis, torch.randn((t, p, 3), generator=gen, device=cuda),
            torch.randn((t, p), generator=gen, device=cuda), t_fin, last)
    stale = torch.full((feats.shape[0], tr.NUM_GRAD_COLS), float("nan"), device=cuda)
    del stale  # the allocator hands its block to the kernel's output
    got = tr.tiled_backward(*args)
    want = tr.tiled_backward_plain(*args)
    again = tr.tiled_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = want.abs().amax(dim=0)
    err = (got - want).abs().amax(dim=0)
    assert (err[:11] <= 1e-4 * scale[:11]).all(), (err / scale.clamp(min=1e-30)).tolist()
    stop = torch.maximum(offs[:-1], torch.minimum(last.amax(1) + 1, offs[1:])).tolist()
    ends = offs[1:].tolist()
    assert stop != ends  # some tile has rows past its horizon
    for s, e in zip(stop, ends):
        assert (got[s:e] == 0).all()
    assert int(offs[-1]) < got.shape[0] and (got[int(offs[-1]):] == 0).all()
    assert (got[:, 11:] == 0).all()


def test_segsum_band_matches_plain(cuda, rng):
    """Rows grouped like the backward's flat-sorted gradient rows (groups of
    1-16 rows, then one group far longer than LOOK): each row's sum over
    the rest of its group
    agrees within 1e-5 of the group's absolute sum (the two versions add in
    a different order)."""
    sizes = rng.integers(1, 17, size=40000)
    g = np.repeat(np.arange(sizes.shape[0]), sizes)
    g = np.concatenate([g, np.full(3000, sizes.shape[0])]).astype(np.int32)
    rows = torch.as_tensor(rng.normal(size=(g.shape[0], 16)).astype(np.float32), device=cuda)
    gt = torch.as_tensor(g, device=cuda)
    before = seg.launches
    got = seg.segsum_band(rows, gt)
    want = seg.segsum_band_plain(rows, gt)
    mag = seg.segsum_band_plain(rows.abs(), gt)
    torch.cuda.synchronize()
    assert seg.launches == before + 1
    assert ((got - want).abs() <= 1e-5 * mag).all()


def test_segsum_compact_matches_plain(cuda, rng):
    """Groups of 1-16 rows, one of 700 rows, then a dead tail whose rows
    each have an id of their own (the training path's layout), cut by
    ``max_groups`` after the first dead row: each group's sum within 1e-5 of
    its absolute sum (the plain version's ``index_add_`` adds in another
    order on the card)."""
    sizes = np.concatenate([rng.integers(1, 17, size=20000), [700], rng.integers(1, 17, size=20000)])
    n_live = sizes.shape[0]
    g = np.repeat(np.arange(n_live), sizes)
    g = np.concatenate([g, n_live + np.arange(5000)]).astype(np.int32)
    rows = torch.as_tensor(rng.normal(size=(g.shape[0], 16)).astype(np.float32), device=cuda)
    gt = torch.as_tensor(g, device=cuda)
    before = seg.compact_launches
    got = seg.segsum_compact(rows, gt, n_live + 1)
    want = seg.segsum_compact_plain(rows, gt, n_live + 1)
    mag = seg.segsum_compact_plain(rows.abs(), gt, n_live + 1)
    torch.cuda.synchronize()
    assert seg.compact_launches == before + 1
    assert ((got - want).abs() <= 1e-5 * mag).all()


def _compact_case(rng, case):
    """(ids, max_groups) of one ``segsum_compact`` card case; the kernel's
    blocks own 512 rows each."""
    if case == "lengths_1_300":
        sizes = rng.integers(1, 301, size=3000)
    elif case == "longer_than_a_span":  # groups that start mid-span and run over several
        sizes = np.concatenate([rng.integers(1, 17, size=3000), [5000], rng.integers(1, 5, size=700),
                                [1543], [1], [513]])
    elif case == "ragged_n":
        sizes = rng.integers(1, 17, size=2000)
        sizes[-1] += 512 - sizes.sum() % 512 + 129  # n = 512 k + 129
    elif case == "n_1":
        sizes = np.array([1])
    else:  # "cut_mid_span", "ids_past_2_24"
        sizes = rng.integers(1, 17, size=20000)
    g = np.repeat(np.arange(sizes.shape[0]), sizes)
    groups = sizes.shape[0]
    if case == "ids_past_2_24":  # gaps between ids; f32 would merge neighbours here
        g = 2**24 + 3 * g
    if case == "cut_mid_span":
        return g.astype(np.int32), groups // 2 + 37
    return g.astype(np.int32), groups + 1


@pytest.mark.parametrize("case", ["lengths_1_300", "longer_than_a_span", "ragged_n", "n_1",
                                  "cut_mid_span", "ids_past_2_24"])
def test_segsum_compact_cases(cuda, rng, case):
    """One launch (and one memset) per call across the kernel's blocks and
    their look-back: each written group's sum within 1e-5 of its absolute
    sum (the plain version's ``index_add_`` adds in another order on the
    card), and a second launch gives the same bits (sums in row order, no
    atomics)."""
    g, mg = _compact_case(rng, case)
    assert case != "ragged_n" or g.shape[0] % 512 == 129
    rows = torch.as_tensor(rng.normal(size=(g.shape[0], 16)).astype(np.float32), device=cuda)
    gt = torch.as_tensor(g, device=cuda)
    before = seg.compact_launches
    got = seg.segsum_compact(rows, gt, mg)
    again = seg.segsum_compact(rows, gt, mg)
    want = seg.segsum_compact_plain(rows, gt, mg)
    mag = seg.segsum_compact_plain(rows.abs(), gt, mg)
    torch.cuda.synchronize()
    assert seg.compact_launches == before + 2
    k = min(int(np.unique(g).shape[0]), mg)
    assert torch.equal(got[:k], again[:k])
    assert ((got[:k] - want[:k]).abs() <= 1e-5 * mag[:k]).all()


@pytest.mark.parametrize("c", [1000, 300001])
def test_monotone_expand_matches_plain(cuda, rng, c):
    """A gather of present rows: equal to the plain version bit for bit, at a
    length that is no multiple of any block size."""
    present = torch.as_tensor(rng.uniform(size=c) < 0.7, device=cuda)
    p = present.to(torch.int32)
    rank = torch.cumsum(p, 0, dtype=torch.int32) - p
    compact = torch.as_tensor(rng.normal(size=(int(p.sum()) + 1, 16)).astype(np.float32), device=cuda)
    before = seg.expand_launches
    got = seg.monotone_expand(compact, rank, present)
    want = seg.monotone_expand_plain(compact, rank, present)
    torch.cuda.synchronize()
    assert seg.expand_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,tail", [
    (1, None), (2, None), (3, None), (4, None), (9, None), (16, None), (17, None),
    (4, (16, 3969)), (9, (16, 101)), (17, (16, 5)), (3, (17, 1001)), (20, (1, 7)),
])
def test_group_reduce_matches_plain(cuda, rng, b, tail):
    """Row-order sums: equal to the plain version bit for bit, at every kind
    of instantiation (b = 2, 4, 9, 16 of their own, any other size the
    chunked loop; a tail of 16 rows of its own, any other the loop), with
    and without a tail population in the same launch, and a group count
    that is no multiple of a block's 64 groups."""
    tail_rows = tail[0] * tail[1] if tail else 0
    x = torch.as_tensor(rng.normal(size=(100003 * b + tail_rows, 16)).astype(np.float32), device=cuda)
    before = gr.launches
    got = gr.group_reduce(x, b, tail=tail)
    want = gr.group_reduce_plain(x, b, tail=tail)
    torch.cuda.synchronize()
    assert gr.launches == before + 1
    assert got.shape == (100003 + (tail[1] if tail else 0), 16)
    assert torch.equal(got, want)


def test_wrappers_check_their_inputs(cuda):
    fgeo = torch.zeros((6, 8), device=cuda)
    igeo = torch.zeros((7, 8), dtype=torch.int32, device=cuda)
    kw = dict(n_keys=4, m=16, ts=16, tiles_x=4, num_tiles=16, rank_bits=3, sentinel_flat=128)
    with pytest.raises(ValueError):
        bk.binkeys(fgeo.double(), igeo, **kw)
    with pytest.raises(ValueError):
        bk.binkeys(fgeo[:, ::2], igeo[:, ::2], **kw)
    basis = trt.tile_pixel_basis(trt.image_geometry(64, 64, 32), cuda)
    offs = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tr.tiled_forward(torch.zeros((4, 15), device=cuda), offs, basis)
    big = trt.tile_pixel_basis(trt.image_geometry(64, 64, 64), cuda)
    with pytest.raises(ValueError):
        tr.tiled_forward(torch.zeros((4, 16), device=cuda), offs, big)
    t = torch.zeros((4, 1024), device=cuda)
    last = torch.zeros((4, 1024), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tr.tiled_backward(torch.zeros((4, 16), device=cuda), offs, basis,
                          torch.zeros((4, 3, 1024), device=cuda), t, t, last)
    with pytest.raises(ValueError):
        seg.segsum_band(torch.zeros((4, 16), device=cuda), torch.zeros(4, dtype=torch.int64, device=cuda))
    rows, g = torch.zeros((4, 16), device=cuda), torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        seg.segsum_compact(rows, g.long(), 4)
    with pytest.raises(ValueError):
        seg.segsum_compact(rows[:, :12], g, 4)
    with pytest.raises(ValueError):
        seg.segsum_compact(rows, g, 0)
    present = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        seg.monotone_expand(rows, g, present.int())
    with pytest.raises(ValueError):
        seg.monotone_expand(rows.double(), g, present)
    with pytest.raises(ValueError):
        seg.monotone_expand(rows, g[:3], present)
    with pytest.raises(ValueError):
        gr.group_reduce(rows, 3)
    with pytest.raises(ValueError):
        gr.group_reduce(rows, 2, tail=(3, 1))
    with pytest.raises(ValueError):
        gr.group_reduce(rows.t().contiguous().t(), 2)
    with pytest.raises(ValueError):
        gr.group_reduce(torch.zeros(4 * 16 + 1, device=cuda)[1:].view(4, 16), 2)  # unaligned


def test_eval_latency_chain_replays_a_cuda_graph(cuda, rng):
    """The evaluator's device latency captures its chain of renders in one
    CUDA graph (each render records one ``binkeys`` and one
    ``tiled_forward`` launch into it) and times a replay: a finite positive
    time, the launch counters count the two replays' renders (the capture
    launches nothing), and the renderer still runs eagerly after the
    capture."""
    from types import SimpleNamespace

    from easy_gaussian_splatting_torch.evaluation.evaluator import LATENCY_CHAIN, Evaluator
    from easy_gaussian_splatting_torch.models import gaussians as tg
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn

    n = 512
    arrays = dict(
        means=rng.uniform([-1.0, -1.0, 3.0], [1.0, 1.0, 5.0], size=(n, 3)),
        log_scales=rng.uniform(-3.5, -2.5, size=(n, 3)),
        quats=rng.normal(size=(n, 4)),
        sh_0=rng.normal(0.0, 0.8, size=(n, 1, 3)),
        sh_rest=rng.normal(0.0, 0.2, size=(n, 15, 3)),
        logit_opacities=rng.normal(0.0, 1.5, size=n),
    )
    model = SimpleNamespace(params=tg.params_from_numpy(arrays, cuda),
                            alive=torch.ones(n, dtype=torch.bool, device=cuda))
    height, width = 48, 64
    K = torch.tensor([[60.0, 0, width / 2], [0, 60.0, height / 2], [0, 0, 1]], device=cuda)
    data = dict(w2c=torch.eye(4, device=cuda), K=K, width=width, height=height)
    render_fn = get_render_fn(config_from_dict(dict(renderer="tiled", tile_size=16)))
    ev = Evaluator(0, render_fn)
    bg = torch.zeros(3, device=cuda)
    eager = ev._render(model, data, 3, bg)
    before = (bk.launches, tr.launches)
    ms = ev._chain_ms(model, data, 3, bg)
    assert (bk.launches, tr.launches) == (before[0] + 2 * LATENCY_CHAIN,
                                          before[1] + 2 * LATENCY_CHAIN)
    assert np.isfinite(ms) and ms > 0
    assert torch.equal(ev._render(model, data, 3, bg), eager)


def _model_arrays(rng, n):
    return dict(
        means=rng.uniform([-1.0, -1.0, 3.0], [1.0, 1.0, 5.0], size=(n, 3)),
        log_scales=rng.uniform(-3.5, -2.5, size=(n, 3)),
        quats=rng.normal(size=(n, 4)),
        sh_0=rng.normal(0.0, 0.8, size=(n, 1, 3)),
        sh_rest=rng.normal(0.0, 0.2, size=(n, 15, 3)),
        logit_opacities=rng.normal(0.0, 1.5, size=n),
    )


def test_eval_counting_render_skips_a_captured_chain(cuda, rng):
    """The eval's ``CountingRender`` keeps the count of each eager render and
    none of the renders captured into the latency chain's CUDA graph."""
    from types import SimpleNamespace

    from easy_gaussian_splatting_torch.eval import CountingRender
    from easy_gaussian_splatting_torch.evaluation.evaluator import Evaluator
    from easy_gaussian_splatting_torch.models import gaussians as tg
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn

    n = 512
    model = SimpleNamespace(params=tg.params_from_numpy(_model_arrays(rng, n), cuda),
                            alive=torch.ones(n, dtype=torch.bool, device=cuda))
    K = torch.tensor([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], device=cuda)
    data = dict(w2c=torch.eye(4, device=cuda), K=K, width=64, height=48)
    counting = CountingRender(get_render_fn(config_from_dict(dict(renderer="tiled", tile_size=16))))
    ev = Evaluator(0, counting)
    bg = torch.zeros(3, device=cuda)
    ev._render(model, data, 3, bg)
    ms = ev._chain_ms(model, data, 3, bg)
    ev._render(model, data, 3, bg)
    assert np.isfinite(ms) and len(counting.counts) == 2
    assert int(counting.counts[0]) == int(counting.counts[1]) > 0


def test_batched_step_equals_sequential_on_the_card(cuda, rng):
    """``make_batched_train_step`` against B ``make_grad_fn`` calls, the
    gradients summed in view order and divided by B, the statistics view by
    view and one ``adam_update``, all on the card: equal bit for bit (no
    kernel of the step adds with atomics), and so are two runs."""
    from easy_gaussian_splatting_torch.models import gaussians as tg
    from easy_gaussian_splatting_torch.models.density import update_statistics
    from easy_gaussian_splatting_torch.models.optimizer import adam_update, init_adam_state
    from easy_gaussian_splatting_torch.training import trainer as ttrainer
    from easy_gaussian_splatting_torch.training.config import config_from_dict

    n, b, h, w = 4096, 3, 96, 128
    params = tg.params_from_numpy(_model_arrays(rng, n), cuda)
    state = tg.GaussianModelState(params=params, alive=torch.ones(n, dtype=torch.bool, device=cuda),
                                  stats=tg.zero_stats(n, cuda))
    adam = init_adam_state(params)
    w2cs = torch.eye(4, device=cuda).repeat(b, 1, 1)
    w2cs[:, 0, 3] = torch.tensor([0.0, 0.15, -0.2], device=cuda)
    Ks = torch.tensor([[110.0, 0, w / 2], [0, 110.0, h / 2], [0, 0, 1]], device=cuda).repeat(b, 1, 1)
    images = torch.as_tensor(rng.uniform(size=(b, h, w, 3)), dtype=torch.float32, device=cuda)
    masks = torch.zeros((b, h, w), device=cuda)
    cfg = config_from_dict(dict(renderer="tiled", tile_size=16, isect_mult=8.0))
    kw = dict(height=h, width=w, sh_degree=3)
    render_fn = ttrainer.get_render_fn(cfg)
    grad_fn = ttrainer.make_grad_fn(cfg, render_fn)
    total, stats = params.map(torch.zeros_like), state.stats
    for i in range(b):
        g, a, _, radii = grad_fn(state, w2cs[i], Ks[i], images[i], masks[i], **kw)
        stats = update_statistics(stats, radii, a, h, w)
        total = tg.GaussianParams(**{k: getattr(total, k) + getattr(g, k) for k in tg.PARAM_NAMES})
    lrs = dict(means=1e-3, log_scales=cfg.log_scales_lr, quats=cfg.quats_lr, sh_0=cfg.sh_0_lr,
               sh_rest=cfg.sh_rest_lr, logit_opacities=cfg.logit_opacities_lr)
    want, want_adam = adam_update(params, total.map(lambda x: x / float(b)), adam, lrs,
                                  {k: False for k in tg.PARAM_NAMES})
    step = ttrainer.make_batched_train_step(cfg, render_fn)
    before = (bk.launches, tr.launches, tr.backward_launches, seg.launches)
    runs = [step(state, adam, w2cs, Ks, images, masks, 1e-3, True, False, False, **kw)
            for _ in range(2)]
    after = (bk.launches, tr.launches, tr.backward_launches, seg.launches)
    assert [y - x for x, y in zip(before, after)] == [2 * b] * 4
    for got, got_adam, ld in runs:
        assert int(ld["isects"]) <= trt.isect_capacity(n, cfg.isect_mult)
        for k in tg.PARAM_NAMES:
            assert torch.equal(getattr(got.params, k), getattr(want, k)), k
            assert torch.equal(getattr(got_adam.mu, k), getattr(want_adam.mu, k)), k
        for k in ("grad_norm_accum", "collecting_counts", "max_radii"):
            assert torch.equal(getattr(got.stats, k), getattr(stats, k)), k
