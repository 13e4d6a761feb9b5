"""The backward reductions ``scan``, ``pallas`` and ``dense`` and the grid
binning: the port (plain kernel versions on the CPU) against the JAX
package (Pallas in interpret mode), and against the port's own ``band``
reduction and ``binkeys`` binning, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.ops import rasterize_tiled as jrt
from easy_gaussian_splatting_tpu.ops.pallas import segments as jseg
from easy_gaussian_splatting_tpu.ops.pallas.group_reduce import group_reduce as j_group_reduce
from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels import group_reduce as tgr
from easy_gaussian_splatting_torch.ops.kernels import segments as tseg
from easy_gaussian_splatting_torch.ops.kernels import tile_raster as ttr
from test_torch_rasterize_tiled import BG, H, TS, W, _scene

NAMES = ("means2d", "conics", "colors", "opacities", "absgrad")
R, LANES = jseg.R, jseg.LANES
COLS = tseg.NUM_COLS


@pytest.fixture
def strategy(monkeypatch):
    """Set the backward reduction (and binning grid) in both packages."""

    def set_(reduce, binning="pallas"):
        monkeypatch.setattr(jrt, "BWD_REDUCE", reduce)
        monkeypatch.setattr(trt, "BWD_REDUCE", reduce)
        monkeypatch.setattr(jrt, "BINNING_IMPL", binning)
        monkeypatch.setattr(trt, "BINNING_IMPL", binning)

    return set_


# ---------------------------------------------------------------- kernels
def _groups(rng, n, n_groups, max_mult=16, tail_id=None):
    """Non-decreasing group ids of multiplicity 1..max_mult; the rows past
    them form one tail group (the JAX composition's dead sentinel)."""
    reps = np.repeat(np.arange(n_groups), rng.integers(1, max_mult + 1, size=n_groups))[:n]
    g = np.full(n, n_groups + 7 if tail_id is None else tail_id, np.int32)
    g[: len(reps)] = reps
    return g


def _segsum_case(rng, case):
    if case == "one_block":
        g = _groups(rng, R, R // 3)
    elif case == "three_blocks":
        g = _groups(rng, 3 * R, R)
    elif case == "spanning_blocks":  # one 700-row group across a block boundary
        g = np.zeros(2 * R, np.int32)
        g[700:] = 1
    else:  # a long dead tail: 200 groups, then ~1000 rows of one id
        g = _groups(rng, 3 * R, 200, max_mult=3, tail_id=200)
    return g, rng.normal(size=(g.shape[0], LANES)).astype(np.float32)


@pytest.mark.parametrize("case", ["one_block", "three_blocks", "spanning_blocks", "dead_tail"])
def test_plain_segsum_compact_matches_jax_kernel(rng, case):
    """The cases of the JAX package's own tests, and a long dead tail. The
    JAX kernel sums through a bf16 hi/lo matmul (~2^-16 relative), so the
    stated bound is 2e-4 of the largest sum, as its own test states it;
    against float64 sums the plain version is held to 1e-5 of each group's
    absolute sum (f32 rounding over at most ~1000 rows)."""
    g, rows = _segsum_case(rng, case)
    uniq, inv = np.unique(g, return_inverse=True)
    n_groups = len(uniq)
    want = np.asarray(jseg.segsum_compact(jnp.asarray(rows), jnp.asarray(g), interpret=True))
    got = tseg.segsum_compact(torch.as_tensor(rows[:, :COLS]), torch.as_tensor(g), n_groups).numpy()
    assert got.shape == (n_groups, COLS)
    scale = np.abs(want[:n_groups, :COLS]).max()
    np.testing.assert_allclose(got, want[:n_groups, :COLS], rtol=0, atol=2e-4 * scale)
    exact = np.zeros((n_groups, COLS))
    mag = np.zeros((n_groups, COLS))
    np.add.at(exact, inv, rows[:, :COLS].astype(np.float64))
    np.add.at(mag, inv, np.abs(rows[:, :COLS]).astype(np.float64))
    assert (np.abs(got - exact) <= 1e-5 * mag).all()
    # max_groups bounds the output: the first groups are unchanged
    head = tseg.segsum_compact(torch.as_tensor(rows[:, :COLS]), torch.as_tensor(g), n_groups - 1)
    np.testing.assert_array_equal(head.numpy(), got[: n_groups - 1])


def test_segsum_compact_ids_above_f32_range():
    """Ids at and above 2^24 that differ by one stay apart: the port compares
    them as integers (the JAX kernel compares them as f32)."""
    rows = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, COLS)
    g = torch.tensor([2**24, 2**24 + 1, 2**24 + 1, 2**24 + 2, 2**24 + 3, 2**24 + 3], dtype=torch.int32)
    out = tseg.segsum_compact(rows, g, 4)
    np.testing.assert_array_equal(out[:, 0].numpy(), [0, 3, 3, 9])


@pytest.mark.parametrize("c", [R, 2 * R])
def test_plain_monotone_expand_matches_jax_kernel(rng, c):
    """The JAX kernel rebuilds each row from a bf16 hi/lo one-hot matmul
    (~2^-16 relative): stated bound 1e-4 of the largest value, as its own
    test states it. The plain version is a gather, equal to numpy's."""
    present = rng.uniform(size=c) < 0.7
    rank = (np.cumsum(present) - present).astype(np.int32)
    compact = rng.normal(size=(int(present.sum()), LANES)).astype(np.float32)
    want = np.asarray(jseg.monotone_expand(
        jnp.asarray(compact), jnp.asarray(rank), jnp.asarray(present), interpret=True))
    got = tseg.monotone_expand(
        torch.as_tensor(compact[:, :COLS]), torch.as_tensor(rank), torch.as_tensor(present)
    ).numpy()
    np.testing.assert_allclose(got, want[:, :COLS], rtol=0, atol=1e-4 * np.abs(compact).max())
    exact = np.zeros((c, COLS), np.float32)
    exact[present] = compact[rank[present], :COLS]
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("b", [2, 9, 16])
def test_plain_group_reduce_matches_jax_kernel(rng, b):
    """Both sum f32 rows in f32, in another order (XLA's reduction tree,
    the port's row order): stated bound 1e-6 of each group's absolute sum.
    The plain version adds in row order, equal to numpy's row-order loop."""
    groups = 512
    x = rng.normal(size=(groups * b, LANES)).astype(np.float32)
    want = np.asarray(j_group_reduce(jnp.asarray(x), b, interpret=True))
    got = tgr.group_reduce(torch.as_tensor(x[:, :COLS]), b).numpy()
    mag = np.abs(x[:, :COLS]).reshape(groups, b, COLS).sum(1)
    assert (np.abs(got - want[:, :COLS]) <= 1e-6 * mag).all()
    xs = x[:, :COLS].reshape(groups, b, COLS)
    seq = xs[:, 0].copy()
    for k in range(1, b):
        seq += xs[:, k]
    np.testing.assert_array_equal(got, seq)


def test_roundtrip_segsum_then_expand_matches_jax(rng):
    """The rasterizer's composition (``test_segments.py``'s round trip):
    compacted group sums of groups with gaps, expanded to group space;
    stated bound 2e-4 of the largest sum, as the JAX test states it."""
    n, c = 4 * R, 2 * R
    counts = rng.integers(0, 4, size=c)
    reps = np.repeat(np.arange(c), counts)[:n]
    g = np.full(n, c + 3, np.int32)
    g[: len(reps)] = reps
    rows = rng.normal(size=(n, LANES)).astype(np.float32)
    present = counts > 0
    rank = (np.cumsum(present) - present).astype(np.int32)
    j_out = np.asarray(jseg.monotone_expand(
        jseg.segsum_compact(jnp.asarray(rows), jnp.asarray(g), interpret=True),
        jnp.asarray(rank), jnp.asarray(present), interpret=True))
    compact = tseg.segsum_compact(torch.as_tensor(rows[:, :COLS]), torch.as_tensor(g), c + 1)
    got = tseg.monotone_expand(compact, torch.as_tensor(rank), torch.as_tensor(present)).numpy()
    want = np.zeros((c, COLS), np.float32)
    np.add.at(want, reps, rows[: len(reps), :COLS])
    bound = 2e-4 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(got, j_out[:, :COLS], rtol=0, atol=bound)


# ---------------------------------------------------------- grid binning
def _bin_scene(rng, c=3000):
    """A denser binning scene (the JAX package's binkeys-vs-grid test):
    anisotropic conics so the exact test prunes corner tiles."""
    m2d = rng.uniform(-10, 130, (c, 2)).astype(np.float32)
    L = rng.normal(size=(c, 2, 2)).astype(np.float32) * 2.0
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 1.0
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] ** 2
    con = np.stack([cov[:, 1, 1] / det, -cov[:, 0, 1] / det, cov[:, 0, 0] / det], -1)
    opa = rng.uniform(0.02, 0.95, (c,)).astype(np.float32)
    radii = rng.uniform(0.0, 60, (c,)).astype(np.float32)
    dep = rng.uniform(1, 9, (c,)).astype(np.float32)
    return m2d, con.astype(np.float32), opa, radii, dep


BIN_H, BIN_W, BIN_TS = 96, 128, 32


def _bin_port(scene, small_budget, ov_capacity):
    m2d, con, opa, rad, dep = (torch.as_tensor(x) for x in scene)
    ext = trt.binning_extents(con, opa, rad)
    return trt.bin_gaussians(
        m2d, ext, dep, trt.image_geometry(BIN_H, BIN_W, BIN_TS), 4, 4, conics=con,
        opacities=opa, ov_capacity=ov_capacity, small_budget=small_budget, y_limit=BIN_H,
    )


def _bin_jax(scene, small_budget, ov_capacity):
    m2d, con, opa, rad, dep = (jnp.asarray(x) for x in scene)
    ext = jrt.binning_extents(con, opa, rad)
    return jrt.bin_gaussians(
        m2d, ext, dep, jrt.image_geometry(BIN_H, BIN_W, BIN_TS), 4, 4, conics=con,
        opacities=opa, ov_capacity=ov_capacity, small_budget=small_budget,
        interpret=True, y_limit=jnp.asarray(float(BIN_H), jnp.float32),
    )


def _assert_live_prefix_equal(a, b, n):
    """Live prefix of the sorted entries, CSR offsets and counts equal."""
    for name in ("isect_flat", "isect_tile", "isect_orig"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[:n],
                                      np.asarray(getattr(b, name))[:n], err_msg=name)
    for name in ("tile_offsets", "counts", "num_overflow", "n_gt", "order"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["two_pop", "overflow", "one_pop"])
def test_grid_binning_matches_jax_grid(rng, strategy, case):
    """The port's grid path against the JAX package's under ``dense``: the
    live prefix, ``in_ov`` and ``ov_rank`` are equal; ``dense`` is equal on
    the live prefix (dead entries of one Gaussian tie in the sort, so the
    packages order them differently) and is a permutation of [0, D)."""
    strategy("dense")
    small_budget, ov_capacity = {"two_pop": (4, 512), "overflow": (2, 64),
                                 "one_pop": (16, 512)}[case]
    scene = _bin_scene(rng)
    jb, tb = _bin_jax(scene, small_budget, ov_capacity), _bin_port(scene, small_budget, ov_capacity)
    n = int(jb.num_isects)
    assert int(tb.num_isects) == n > 0
    _assert_live_prefix_equal(tb, jb, n)
    d = tb.dense.numpy()
    assert d.shape == np.asarray(jb.dense).shape == tb.isect_flat.shape
    np.testing.assert_array_equal(d[:n], np.asarray(jb.dense)[:n])
    np.testing.assert_array_equal(np.sort(d), np.arange(d.shape[0]))
    if case == "one_pop":
        assert tb.in_ov is None and jb.in_ov is None
    else:
        np.testing.assert_array_equal(tb.in_ov.numpy(), np.asarray(jb.in_ov))
        np.testing.assert_array_equal(tb.ov_rank.numpy(), np.asarray(jb.ov_rank))
        assert int(tb.num_overflow) > (ov_capacity if case == "overflow" else 0)


@pytest.mark.parametrize("small_budget", [2, 4, 9])
def test_grid_binning_matches_binkeys(rng, strategy, small_budget):
    """The port's grid path against its own ``binkeys`` path (the JAX
    package's ``test_binkeys_kernel_matches_xla_grid``): the same exact
    test in the same term order keeps the same cells, bit for bit."""
    scene = _bin_scene(rng)
    strategy("band", "xla")
    grid = _bin_port(scene, small_budget, 512)
    strategy("band", "pallas")
    keys = _bin_port(scene, small_budget, 512)
    n = int(keys.num_isects)
    assert int(grid.num_isects) == n > 0 and grid.dense is None
    _assert_live_prefix_equal(grid, keys, n)


def test_unknown_switch_values_raise(rng, monkeypatch):
    scene = _bin_scene(rng, c=50)
    monkeypatch.setattr(trt, "BWD_REDUCE", "sparse")
    with pytest.raises(ValueError, match="BWD_REDUCE"):
        _bin_port(scene, 4, 128)
    monkeypatch.setattr(trt, "BWD_REDUCE", "band")
    monkeypatch.setattr(trt, "BINNING_IMPL", "triton")
    with pytest.raises(ValueError, match="BINNING_IMPL"):
        _bin_port(scene, 4, 128)


# -------------------------------------------------------------- gradients
def _grads(pkg, scene, g_img, isect_mult=8, max_tiles=4):
    """All five inputs' gradients of sum(img * g_img) + sum(alpha^2)."""
    kw = dict(tile_size=TS, isect_mult=isect_mult, max_tiles_w=max_tiles, max_tiles_h=max_tiles)
    if pkg == "jax":
        m2d, con, col, opa, dep, rad = (jnp.asarray(x) for x in scene)

        def loss(m, c, k, o, d):
            img, alpha = jrt.rasterize_tiled(
                m, c, k, o, dep, jnp.asarray(BG), d, H, W, radii=rad, interpret=True, **kw)
            return jnp.sum(img * jnp.asarray(g_img)) + jnp.sum(alpha**2)

        dummy = jnp.zeros((m2d.shape[0], 2))
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(m2d, con, col, opa, dummy)]
    m2d, con, col, opa, dep, rad = (torch.as_tensor(x) for x in scene)
    leaves = [x.clone().requires_grad_(True) for x in (m2d, con, col, opa)]
    dummy = torch.zeros((m2d.shape[0], 2), requires_grad=True)
    img, alpha = trt.rasterize_tiled(*leaves, dep, torch.as_tensor(BG), dummy, H, W, radii=rad, **kw)
    loss = torch.sum(img * torch.as_tensor(g_img)) + torch.sum(alpha**2)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves + [dummy])]


def _assert_close_to_band(got, band):
    """Another strategy sums the same rows in another order (``dense`` adds
    its population-B sums with one more add): 1e-5 relative, with the same
    fraction of each input's largest gradient as the floor."""
    for name, a, b in zip(NAMES, got, band):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("max_opac", [0.3, 0.9])
@pytest.mark.parametrize("reduce", ["scan", "pallas", "dense"])
def test_strategy_grads_match_jax(rng, strategy, reduce, max_opac):
    """All five inputs' gradients under one reduction in both packages. The
    JAX backward's bf16 hi/lo scans and basis-moment conic gradient carry
    ~1e-4 relative error; stated bound atol 5e-4, rtol 2e-3 (the JAX
    package's own tiled-vs-oracle bound). Against the port's ``band``: 1e-5
    relative (summation order only)."""
    scene = _scene(rng, max_opac=max_opac, big=max_opac > 0.5)
    g_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    strategy("band")
    band = _grads("torch", scene, g_img)
    strategy(reduce)
    want = _grads("jax", scene, g_img)
    got = _grads("torch", scene, g_img)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-3, err_msg=name)
    assert np.abs(got[4]).max() > 0
    _assert_close_to_band(got, band)


@pytest.mark.parametrize("reduce", ["pallas", "dense"])
def test_truncated_capacity_gives_zero_gradient(rng, strategy, reduce):
    """A capacity below the binned count zeroes the rasterizer gradient under
    ``pallas`` and ``dense`` too, in both packages."""
    scene = _scene(rng, max_opac=0.6, big=True)
    g_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    strategy(reduce)
    for pkg in ("torch", "jax"):
        for name, g in zip(NAMES, _grads(pkg, scene, g_img, isect_mult=0.5)):
            np.testing.assert_array_equal(g, 0.0, err_msg=f"{pkg} {name}")
    assert np.abs(_grads("torch", scene, g_img, isect_mult=16)[0]).max() > 0


def test_dense_reads_zero_rows_past_the_live_prefix(rng, strategy):
    """The dense reduction gathers the rows of dead sort positions inside
    the capacity ([num_isects, icap)) without masking them: it relies on
    ``tiled_backward`` writing zeros outside every tile's range."""
    strategy("dense")
    m2d, con, col, opa, dep, rad = (torch.as_tensor(x) for x in _scene(rng, big=True))
    icap = trt.isect_capacity(m2d.shape[0], 16)
    geom, binning, feats = trt._prepare(m2d, con, col, opa, rad, dep, H, W, TS, 4, 4, icap)
    n = int(binning.num_isects)
    assert n < feats.shape[0] == icap
    basis = trt.tile_pixel_basis(geom)
    _, t_fin, last = ttr.tiled_forward(feats, binning.tile_offsets, basis)
    g = torch.as_tensor(rng.normal(size=(geom.num_tiles, TS * TS, 3)).astype(np.float32))
    rows = ttr.tiled_backward(feats, binning.tile_offsets, basis, g, g[..., 0].contiguous(),
                              t_fin, last)
    assert bool((rows[:n].abs().sum(1) > 0).any()) and bool((rows[n:] == 0).all())
    q = torch.empty_like(binning.dense).scatter_(
        0, binning.dense, torch.arange(binning.dense.shape[0]))
    assert bool(((q >= n) & (q < icap)).any())  # dense slots read those rows


def test_band_limit_falls_back_to_scan(rng, strategy):
    """A 12x12 window (144 cells) exceeds the band kernel's 128-row
    lookahead: ``band`` falls back to ``scan`` in both packages, so the
    gradients match JAX's (stated bound atol 5e-4, rtol 2e-3, as above) and
    equal the port's own ``scan``. Binning goes through the grid, which
    spares interpreting a 144-cell ``binkeys`` (tens of seconds to
    compile); the binnings agree bit for bit (above)."""
    scene = _scene(rng, max_opac=0.9, big=True)
    g_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    strategy("band", "xla")
    want = _grads("jax", scene, g_img, max_tiles=12)
    got = _grads("torch", scene, g_img, max_tiles=12)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-3, err_msg=name)
    assert np.abs(got[0]).max() > 0
    strategy("scan", "xla")
    for name, a, b in zip(NAMES, _grads("torch", scene, g_img, max_tiles=12), got):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("reduce, binning", [
    ("scan", "pallas"), ("pallas", "pallas"), ("dense", "pallas"), ("band", "xla"),
])
def test_make_grad_fn_matches_jax_per_strategy(rng, strategy, reduce, binning):
    """One ``make_grad_fn`` step of the tiled trainer under each reduction
    (and the band reduction over the grid binning) in both packages:
    gradients, absgrad and radii, at ``test_make_grad_fn_matches_jax``'s
    bound (1e-3 relative L2 per parameter)."""
    from test_torch_training import N, _grads_both, _np, _rel_l2
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES

    strategy(reduce, binning)
    (jgrads, jabs, jld, jradii), (tgrads, tabs, tld, tradii) = _grads_both(rng)
    np.testing.assert_array_equal(_np(tradii), _np(jradii))
    np.testing.assert_allclose(float(tld["total"]), float(jld["total"]), rtol=1e-5)
    for k in PARAM_NAMES:
        a, b = _np(getattr(tgrads, k)), _np(getattr(jgrads, k))
        assert np.abs(b).max() > 0, k
        assert _rel_l2(a, b) < 1e-3, (k, _rel_l2(a, b))
    assert _rel_l2(_np(tabs), _np(jabs)) < 1e-3
    np.testing.assert_array_equal(_np(tabs)[N:], 0.0)
