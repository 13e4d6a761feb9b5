"""Tiled rasterizer parity: the PyTorch port (plain kernel versions on the
CPU) against the JAX package's tiled rasterizer (Pallas in interpret
mode) and against both oracles, on the same numpy scenes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easy_gaussian_splatting_tpu.ops import rasterize_tiled as jrt
from easy_gaussian_splatting_tpu.ops.pallas.tile_raster import tiled_forward as jax_tiled_forward
from easy_gaussian_splatting_tpu.ops.rasterize_ref import rasterize as jax_rasterize
from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels.tile_raster import tiled_forward
from easy_gaussian_splatting_torch.ops.rasterize_ref import rasterize

H, W = 40, 72
TS = 16
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _scene(rng, n=60, max_opac=0.95, big=False):
    means2d = rng.uniform([-6, -6], [W + 6, H + 6], size=(n, 2)).astype(np.float32)
    L = rng.normal(size=(n, 2, 2)).astype(np.float32) * (2.0 if big else 0.6)
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 1.5
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] ** 2
    conics = np.stack(
        [cov[:, 1, 1] / det, -cov[:, 0, 1] / det, cov[:, 0, 0] / det], -1
    ).astype(np.float32)
    b = 0.5 * (cov[:, 0, 0] + cov[:, 1, 1])
    radii = np.ceil(3.0 * np.sqrt(b + np.sqrt(np.maximum(b * b - det, 0.01))))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, max_opac, size=(n,)).astype(np.float32)
    depths = rng.uniform(1.0, 10.0, size=(n,)).astype(np.float32)
    opac[:3] = 0.0
    radii[:3] = 0.0
    return means2d, conics, colors, opac, depths, radii.astype(np.float32)


def _jax_tiled(scene, bg=BG, **kw):
    m2d, con, col, opa, dep, rad = (jnp.asarray(x) for x in scene)
    out = jrt.rasterize_tiled(
        m2d, con, col, opa, dep, jnp.asarray(bg), jnp.zeros((m2d.shape[0], 2)),
        H, W, radii=rad, tile_size=TS, interpret=True, **kw,
    )
    return tuple(np.asarray(x) for x in out)


def _torch_tiled(scene, bg=BG, **kw):
    m2d, con, col, opa, dep, rad = (torch.as_tensor(x) for x in scene)
    out = trt.rasterize_tiled(
        m2d, con, col, opa, dep, torch.as_tensor(bg), None, H, W, radii=rad,
        tile_size=TS, **kw,
    )
    return tuple(x.numpy() for x in out)


def _torch_oracle(scene, bg=BG):
    m2d, con, col, opa, dep, _ = (torch.as_tensor(x) for x in scene)
    img, alpha = rasterize(m2d, con, col, opa, dep, torch.as_tensor(bg), None, H, W)
    return img.numpy(), alpha.numpy()


@pytest.mark.parametrize("max_opac", [0.3, 0.95])
def test_plain_tiled_forward_matches_jax_kernel(rng, max_opac):
    """Same packed features and offsets into both forward kernels."""
    m2d, con, col, opa, dep, rad = (jnp.asarray(x) for x in _scene(rng, max_opac=max_opac))
    geom, binning, feats = jrt._prepare(
        m2d, con, col, opa, rad, dep, H, W, TS, 4, 4,
        isect_cap=trt.isect_capacity(60, 8), interpret=True,
    )
    basis = jrt.tile_pixel_basis(geom)
    j_rgb, j_t, j_last = (np.asarray(x) for x in jax_tiled_forward(
        feats, binning.tile_offsets, basis, geom.num_tiles, interpret=True))
    t_rgb, t_t, t_last = tiled_forward(
        torch.as_tensor(np.ascontiguousarray(np.asarray(feats).T)),
        torch.as_tensor(np.array(binning.tile_offsets)),
        torch.as_tensor(np.array(basis)),
    )
    # the JAX kernel forms T as exp(sum log(1 - alpha)), the port as a
    # running product: f32 rounding apart, well below 1e-5
    np.testing.assert_allclose(t_rgb.numpy(), j_rgb, atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), j_t, atol=1e-5)
    np.testing.assert_array_equal(t_last.numpy(), j_last)
    assert (j_last >= 0).mean() > 0.3


def test_tiled_matches_jax_low_opacity(rng):
    scene = _scene(rng, max_opac=0.3)
    j_img, j_alpha = _jax_tiled(scene, isect_mult=8)
    t_img, t_alpha = _torch_tiled(scene, isect_mult=8)
    np.testing.assert_allclose(t_img, j_img, atol=2e-5)
    np.testing.assert_allclose(t_alpha, j_alpha, atol=2e-5)


def test_tiled_matches_jax_high_opacity(rng):
    """At opacity up to 0.95 pixels saturate and stop early; both
    packages bin the same tiles, so only the transmittance rounding
    differs. Stated bound: 1e-4 (5x the low-opacity bound)."""
    scene = _scene(rng, max_opac=0.95, big=True)
    j_img, j_alpha = _jax_tiled(scene, isect_mult=16)
    t_img, t_alpha = _torch_tiled(scene, isect_mult=16)
    np.testing.assert_allclose(t_img, j_img, atol=1e-4)
    np.testing.assert_allclose(t_alpha, j_alpha, atol=1e-4)


def test_tiled_matches_oracles_low_opacity(rng):
    """With opacity <= 0.3 contributions outside the 3-sigma box fall below
    the 1/255 threshold, so the tiled result equals the oracle."""
    scene = _scene(rng, max_opac=0.3)
    t_img, t_alpha = _torch_tiled(scene, isect_mult=8)
    o_img, o_alpha = _torch_oracle(scene)
    np.testing.assert_allclose(t_img, o_img, atol=2e-5)
    np.testing.assert_allclose(t_alpha, o_alpha, atol=2e-5)
    jo_img, jo_alpha = jax_rasterize(
        *(jnp.asarray(x) for x in scene[:5]), jnp.asarray(BG),
        jnp.zeros((scene[0].shape[0], 2)), H, W,
    )
    np.testing.assert_allclose(o_img, np.asarray(jo_img), atol=1e-5)
    np.testing.assert_allclose(o_alpha, np.asarray(jo_alpha), atol=1e-5)


def test_empty_scene_is_background(rng):
    m2d, con, col, opa, dep, rad = _scene(rng, n=5)
    bg = np.array([0.6, 0.5, 0.4], np.float32)
    img, alpha = _torch_tiled(
        (m2d, con, col, np.zeros_like(opa), dep, np.zeros_like(rad)), bg=bg
    )
    np.testing.assert_allclose(img, np.broadcast_to(bg, (H, W, 3)), atol=1e-7)
    np.testing.assert_allclose(alpha, 0.0, atol=1e-7)


def test_opaque_stack_stops_early(rng):
    """Sixty near-opaque Gaussians stacked on one spot: covered pixels stop
    after a few of them (T < 1e-4) and agree with the JAX tiled rasterizer,
    and with the oracle where the stack saturates (at opacity 0.95 the
    oracle also composites the faint rim beyond 3 sigma, which binning
    cuts, as in the JAX package)."""
    n = 60
    m2d = np.tile(np.array([[30.0, 20.0]], np.float32), (n, 1))
    m2d += rng.normal(0, 0.5, size=(n, 2)).astype(np.float32)
    con = np.tile(np.array([[0.02, 0.0, 0.02]], np.float32), (n, 1))
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    opa = np.full((n,), 0.95, np.float32)
    dep = rng.uniform(1.0, 10.0, size=(n,)).astype(np.float32)
    rad = np.full((n,), 22.0, np.float32)
    scene = (m2d, con, col, opa, dep, rad)
    t_img, t_alpha = _torch_tiled(scene, isect_mult=16)
    j_img, j_alpha = _jax_tiled(scene, isect_mult=16)
    o_img, _ = _torch_oracle(scene)
    assert t_alpha[20, 30] > 1.0 - 1e-3
    np.testing.assert_allclose(t_img, j_img, atol=1e-4)
    np.testing.assert_allclose(t_img[14:27, 24:37], o_img[14:27, 24:37], atol=1e-4)
    # the front-most Gaussian dominates the stopped center pixel
    front = np.argmin(dep)
    np.testing.assert_allclose(t_img[20, 30], col[front], atol=0.1)


def test_num_isects_and_capacity(rng):
    """The returned count (all binned intersections) equals the JAX one; a
    capacity below it truncates both packages' renders identically."""
    scene = _scene(rng, max_opac=0.6, big=True)
    t_img, _, n = _torch_tiled(scene, isect_mult=0.5, return_isects=True)
    j_img, _, jn = _jax_tiled(scene, isect_mult=0.5, return_isects=True)
    assert int(n) == int(jn) > trt.isect_capacity(60, 0.5)
    np.testing.assert_allclose(t_img, j_img, atol=1e-4)
