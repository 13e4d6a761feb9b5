"""Binning parity: the PyTorch port's plain ``binkeys`` and ``bin_gaussians``
against the JAX package's (Pallas in interpret mode) on the same numpy
inputs. Keys, flat ids, CSR offsets, per-tile depth order and counts are
integers and must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easy_gaussian_splatting_tpu.ops.pallas.binkeys import GBLK
from easy_gaussian_splatting_tpu.ops.pallas.binkeys import binkeys as jax_binkeys
from easy_gaussian_splatting_tpu.ops import rasterize_tiled as jrt
from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk

H, W = 40, 72  # non-multiples of the tile size exercise padding
TS = 16


def _scene(rng, n=60, max_opac=0.95, big=False):
    """Screen-space Gaussians as numpy arrays (the JAX tests' scene)."""
    means2d = rng.uniform([-6, -6], [W + 6, H + 6], size=(n, 2)).astype(np.float32)
    L = rng.normal(size=(n, 2, 2)).astype(np.float32) * (2.0 if big else 0.6)
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 1.5
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] ** 2
    conics = np.stack(
        [cov[:, 1, 1] / det, -cov[:, 0, 1] / det, cov[:, 0, 0] / det], -1
    ).astype(np.float32)
    b = 0.5 * (cov[:, 0, 0] + cov[:, 1, 1])
    radii = np.ceil(3.0 * np.sqrt(b + np.sqrt(np.maximum(b * b - det, 0.01))))
    opac = rng.uniform(0.05, max_opac, size=(n,)).astype(np.float32)
    depths = rng.uniform(1.0, 10.0, size=(n,)).astype(np.float32)
    opac[:3] = 0.0
    radii[:3] = 0.0
    return means2d, conics, opac, radii.astype(np.float32), depths


def _random_rows(rng, c, m, tiles_x=6, tiles_y=5):
    """Random binkeys rows: windows inside a tiles_x x tiles_y grid."""
    w = rng.integers(1, 5, size=c)
    h = np.maximum(1, np.minimum(rng.integers(1, 5, size=c), m // w))
    tx0 = rng.integers(0, tiles_x - w + 1)
    ty0 = rng.integers(0, tiles_y - h + 1)
    count = np.where(rng.uniform(size=c) < 0.9, w * h, 0)
    mx = ((tx0 + w * rng.uniform(size=c)) * TS).astype(np.float32)
    my = ((ty0 + h * rng.uniform(size=c)) * TS).astype(np.float32)
    m2d, conics, opac, _, _ = _scene(rng, n=c, big=True)
    s_max = np.clip(np.log(np.maximum(opac, 1e-12) / (1.0 / 255.0)), 0.0, 4.5).astype(np.float32)
    rank = rng.permutation(c)
    livebase = rng.uniform(size=c) < 0.8
    orig = np.arange(c)
    return dict(
        mx=mx, my=my, tx0=tx0, ty0=ty0, w=w, h=h, a=conics[:, 0], b=conics[:, 1],
        cc=conics[:, 2], s_max=s_max, rank=rank, livebase=livebase, count=count,
        orig=orig,
    )


@pytest.mark.parametrize("n_keys", [4, 16])
def test_plain_binkeys_matches_jax_binkeys(rng, n_keys):
    c, m = 200, 16
    r = _random_rows(rng, c, m)
    c_pad = -(-c // GBLK) * GBLK
    names = ("mx", "my", "tx0", "ty0", "w", "h", "a", "b", "cc", "s_max",
             "rank", "livebase", "count", "orig")
    feats = np.zeros((16, c_pad), np.float32)
    for i, k in enumerate(names):
        feats[i, :c] = r[k]
    rank_bits = (c - 1).bit_length()
    kw = dict(n_keys=n_keys, m=m, ts=TS, tiles_x=6, num_tiles=30,
              rank_bits=rank_bits, sentinel_flat=c * m)
    jk, jf, jcs, jcf = (np.asarray(x)[..., :c] for x in
                        jax_binkeys(jnp.asarray(feats), interpret=True, **kw))
    fgeo = torch.as_tensor(np.stack([r[k] for k in ("mx", "my", "a", "b", "cc", "s_max")]))
    igeo = torch.as_tensor(np.stack(
        [r[k] for k in ("tx0", "ty0", "w", "count", "rank", "orig", "livebase")]
    ).astype(np.int32))
    tk, tf, tcs, tcf = bk.population_plain(fgeo, igeo, **kw)
    np.testing.assert_array_equal(tk.numpy(), jk.astype(np.int64))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tcs.numpy(), jcs)
    np.testing.assert_array_equal(tcf.numpy(), jcf)
    assert (tcf.numpy() > 0).sum() > c // 2  # the exact test kept real cells


@pytest.mark.parametrize("n_keys", [2, 4, 9])
def test_binkeys_plain_is_two_populations(rng, n_keys):
    """The two-population plain ``binkeys`` (the kernel's function) against
    two one-population calls, as the JAX package makes them: population A
    with its keys live where ``pop`` is 1, the tail's rows gathered (an
    empty slot takes the last row, its keys dead), and the counts taken from
    the full window for the tail's rows."""
    c, m = 300, 16
    r = _random_rows(rng, c, m)
    fgeo = torch.as_tensor(np.stack([r[k] for k in ("mx", "my", "a", "b", "cc", "s_max")]))
    ints = [torch.as_tensor(r[k].astype(np.int32)) for k in ("tx0", "ty0", "w", "count", "rank", "orig")]
    big = np.flatnonzero(r["count"] > n_keys)
    named = np.sort(rng.choice(big, size=len(big) // 2, replace=False))
    in_tail = np.zeros(c, bool)
    in_tail[named] = True
    pop = np.where(in_tail, bk.POP_TAIL, r["livebase"] & ~in_tail).astype(np.int32)
    tail = torch.as_tensor(np.concatenate([named, np.full(7, c)]))  # 7 empty slots
    kw = dict(m=m, ts=TS, tiles_x=6, num_tiles=30, rank_bits=(c - 1).bit_length(),
              sentinel_flat=c * m)
    keys, flats, counts = bk.binkeys(
        fgeo, torch.stack(ints + [torch.as_tensor(pop)]), n_keys=n_keys, tail=tail, **kw)
    ka, fa, cs, cf = bk.population_plain(
        fgeo, torch.stack(ints + [torch.as_tensor((pop == bk.POP_A).astype(np.int32))]),
        n_keys=n_keys, **kw)
    row = torch.clamp(tail, max=c - 1)
    kb, fb, _, _ = bk.population_plain(
        fgeo[:, row].contiguous(), torch.stack([x[row] for x in ints] + [(tail < c).to(torch.int32)]),
        n_keys=m, **kw)
    assert len(named) > 5
    assert torch.equal(keys, torch.cat([ka.reshape(-1), kb.reshape(-1)]))
    assert torch.equal(flats, torch.cat([fa.reshape(-1), fb.reshape(-1)]))
    assert torch.equal(counts, torch.where(torch.as_tensor(in_tail), cf, cs))
    assert (cf[named] > cs[named]).any()  # the tail's rows count past n_keys


def _bin_both(scene, small_budget, ov_capacity):
    m2d, con, opa, rad, dep = scene
    geom = jrt.image_geometry(H, W, TS)
    ext = np.array(jrt.binning_extents(jnp.asarray(con), jnp.asarray(opa), jnp.asarray(rad)))
    jb = jrt.bin_gaussians(
        jnp.asarray(m2d), jnp.asarray(ext), jnp.asarray(dep), geom, 4, 4,
        conics=jnp.asarray(con), opacities=jnp.asarray(opa),
        ov_capacity=ov_capacity, small_budget=small_budget, interpret=True,
        y_limit=jnp.asarray(float(H), jnp.float32),
    )
    tb = trt.bin_gaussians(
        torch.as_tensor(m2d), torch.as_tensor(ext), torch.as_tensor(dep),
        trt.image_geometry(H, W, TS), 4, 4, conics=torch.as_tensor(con),
        opacities=torch.as_tensor(opa), ov_capacity=ov_capacity,
        small_budget=small_budget, y_limit=H,
    )
    return jb, tb


def _assert_same_binning(jb, tb):
    n = int(jb.num_isects)
    assert int(tb.num_isects) == n and n > 0
    np.testing.assert_array_equal(tb.tile_offsets.numpy(), np.asarray(jb.tile_offsets))
    np.testing.assert_array_equal(tb.isect_orig[:n].numpy(), np.asarray(jb.isect_orig)[:n])
    np.testing.assert_array_equal(tb.isect_flat[:n].numpy(), np.asarray(jb.isect_flat)[:n])
    np.testing.assert_array_equal(tb.isect_tile[:n].numpy(), np.asarray(jb.isect_tile)[:n])
    # past the live entries only dead ones (the JAX domain is lane-padded)
    assert bool((tb.isect_tile[n:] == tb.tile_offsets.shape[0] - 1).all())
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert int(tb.num_overflow) == int(jb.num_overflow)
    np.testing.assert_array_equal(tb.n_gt.numpy(), np.asarray(jb.n_gt))
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))


@pytest.mark.parametrize("small_budget", [2, 4, 9])
def test_bin_gaussians_matches_jax(rng, small_budget):
    jb, tb = _bin_both(_scene(rng, n=80, big=True), small_budget, None)
    _assert_same_binning(jb, tb)


def test_bin_gaussians_overflow_matches_jax(rng):
    """An overflow capacity smaller than the big-window population: the
    Gaussians beyond it keep only their first small_budget cells, in both
    packages alike."""
    scene = _scene(rng, n=80, big=True)
    jb, tb = _bin_both(scene, 2, 4)
    assert int(jb.num_overflow) > 4
    _assert_same_binning(jb, tb)


def test_tile_roundtrip(rng):
    img = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    geom = trt.image_geometry(H, W, TS)
    back = trt.tiles_to_image(trt.image_to_tiles(img, geom, H, W), geom, H, W)
    np.testing.assert_array_equal(back.numpy(), img.numpy())
    jt = np.asarray(jrt.image_to_tiles(jnp.asarray(img.numpy()), geom, H, W))
    np.testing.assert_array_equal(trt.image_to_tiles(img, geom, H, W).numpy(), jt)
