"""Rasterizer gradient parity: the port's backward kernels (plain versions
on the CPU) against the JAX package's Pallas kernels (interpret mode), and
the port's tiled and oracle gradients against the JAX package's and
against each other, on the same numpy scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.models.render import CameraView as JCameraView
from easy_gaussian_splatting_tpu.models.render import render as j_render
from easy_gaussian_splatting_tpu.ops import rasterize_tiled as jrt
from easy_gaussian_splatting_tpu.ops.pallas import segments as jseg
from easy_gaussian_splatting_tpu.ops.pallas import tile_raster as jtr
from easy_gaussian_splatting_tpu.ops.rasterize_ref import rasterize as j_rasterize
from easy_gaussian_splatting_torch.models.render import CameraView, render
from easy_gaussian_splatting_torch.ops import clip as tclip
from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.ops.kernels import segments as tseg
from easy_gaussian_splatting_torch.ops.kernels import tile_raster as ttr
from easy_gaussian_splatting_torch.ops.rasterize_ref import rasterize
from test_torch_rasterize_tiled import BG, H, TS, W, _scene

NAMES = ("means2d", "conics", "colors", "opacities", "absgrad")


def _loss_weights(rng):
    g_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    return g_img


def _jax_grads(scene, g_img, tiled: bool, isect_mult=8):
    m2d, con, col, opa, dep, rad = (jnp.asarray(x) for x in scene)
    bg = jnp.asarray(BG)

    def loss(m, c, k, o, d):
        if tiled:
            img, alpha = jrt.rasterize_tiled(
                m, c, k, o, dep, bg, d, H, W, radii=rad, tile_size=TS,
                interpret=True, isect_mult=isect_mult,
            )
        else:
            img, alpha = j_rasterize(m, c, k, o, dep, bg, d, H, W, radii=rad)
        return jnp.sum(img * jnp.asarray(g_img)) + jnp.sum(alpha**2)

    dummy = jnp.zeros((m2d.shape[0], 2))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(m2d, con, col, opa, dummy)
    return [np.asarray(g) for g in grads]


def _torch_grads(scene, g_img, tiled: bool, isect_mult=8):
    m2d, con, col, opa, dep, rad = (torch.as_tensor(x) for x in scene)
    leaves = [x.clone().requires_grad_(True) for x in (m2d, con, col, opa)]
    dummy = torch.zeros((m2d.shape[0], 2), requires_grad=True)
    bg = torch.as_tensor(BG)
    if tiled:
        img, alpha = trt.rasterize_tiled(
            *leaves, dep, bg, dummy, H, W, radii=rad, tile_size=TS, isect_mult=isect_mult,
        )
    else:
        img, alpha = rasterize(*leaves, dep, bg, dummy, H, W, radii=rad)
    loss = torch.sum(img * torch.as_tensor(g_img)) + torch.sum(alpha**2)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves + [dummy])]


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("max_opac", [0.3, 0.9])
def test_plain_tiled_backward_matches_jax_kernel(rng, max_opac):
    """Same features, offsets, cotangents, final T and last contributor into
    both backward kernels. The JAX kernel forms transmittance and suffix
    sums with bf16 hi/lo matmul scans (~2^-16 relative) and the conic
    gradient from basis moments, which cancel; stated bound: 2e-4 of each
    column's largest magnitude."""
    _check_backward_parity(rng, _scene(rng, max_opac=max_opac, big=max_opac > 0.5))


def test_plain_tiled_backward_matches_jax_kernel_low_opacity(rng):
    """The same comparison on 200 Gaussians of opacity 0.01-0.1: no pixel
    saturates, so each walks to its own last contributor, and the largest
    ``last`` of some 64-pixel warp of the port's kernel (an 8x8 block of a
    16x16 tile) lies below its tile's, the regime in which the kernel's
    warps stop short of the tile's horizon."""
    scene = list(_scene(rng, n=200))
    scene[3] = np.where(scene[3] > 0, rng.uniform(0.01, 0.1, size=200), 0).astype(np.float32)
    last = _check_backward_parity(rng, scene)
    padded = np.concatenate([last, np.full((last.shape[0], 1), -1, last.dtype)], 1)
    warp_h = padded[:, ttr.warp_pixels(TS * TS).numpy()].max(axis=2)
    assert (warp_h < last.max(axis=1, keepdims=True)).any()


def _check_backward_parity(rng, scene):
    """Both backward kernels on one scene's forward; returns ``last``."""
    m2d, con, col, opa, dep, rad = (jnp.asarray(x) for x in scene)
    geom, binning, feats = jrt._prepare(
        m2d, con, col, opa, rad, dep, H, W, TS, 4, 4,
        isect_cap=trt.isect_capacity(m2d.shape[0], 8), interpret=True,
    )
    basis = jrt.tile_pixel_basis(geom)
    _, t_fin, last = jtr.tiled_forward(
        feats, binning.tile_offsets, basis, geom.num_tiles, interpret=True
    )
    t = geom.num_tiles
    p = TS * TS
    g_img = rng.normal(size=(t, p, 3)).astype(np.float32)
    g_t = rng.normal(size=(t, p)).astype(np.float32)
    j_rows = jtr.tiled_backward(
        feats, binning.tile_offsets, basis, jnp.asarray(np.swapaxes(g_img, 1, 2)),
        jnp.asarray(g_t), t_fin, last, interpret=True,
    )
    want = np.asarray(jtr.grad_rows_to_f32(j_rows, 11))
    got = ttr.tiled_backward(
        torch.as_tensor(np.ascontiguousarray(np.asarray(feats).T)),
        torch.as_tensor(np.array(binning.tile_offsets)),
        torch.as_tensor(np.array(basis)),
        torch.as_tensor(g_img), torch.as_tensor(g_t),
        torch.as_tensor(np.array(t_fin)), torch.as_tensor(np.array(last)),
    ).numpy()
    assert got.shape == (want.shape[0], ttr.NUM_GRAD_COLS)
    np.testing.assert_array_equal(got[:, 11:], 0.0)
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_allclose(got[:, :11], want, rtol=0, atol=2e-4 * scale.max())
    for k in range(11):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=0, atol=2e-4 * scale[k])
    return np.array(last)


def _suffix_sums(rows, g, look):
    out = np.zeros_like(rows, dtype=np.float64)
    for i in range(rows.shape[0]):
        j = i
        while j < min(rows.shape[0], i + look) and g[j] == g[i]:
            out[i] += rows[j]
            j += 1
    return out


@pytest.mark.parametrize("case", ["spanning_blocks", "look_rows_at_boundary"])
def test_plain_segsum_band_matches_jax_kernel(case):
    """Groups straddling the JAX kernel's 512-row blocks, and a group of
    exactly LOOK rows starting on a block's last row. Both sum f32 rows;
    the JAX kernel through a bf16 hi/lo matmul (~2^-16 relative), so the
    stated bound is 2e-4 of the largest sum, as the JAX package's own
    test states it."""
    rng = np.random.default_rng(5)
    r, look = jseg.R, jseg.LOOK
    assert tseg.LOOK == look
    if case == "spanning_blocks":
        n = 2 * r + look
        g = np.arange(n, dtype=np.int32) // 7
    else:
        n = r + look
        g = np.zeros(n, np.int32)
        g[: r - 1] = np.arange(r - 1) // 3
        g[r - 1 :] = 10_000
        g[r - 1 + look :] = 20_000
    rows = rng.normal(size=(n, jseg.LANES)).astype(np.float32)
    want = np.asarray(jseg.segsum_band(jnp.asarray(rows), jnp.asarray(g), interpret=True))
    got = tseg.segsum_band(torch.as_tensor(rows[:, :16]), torch.as_tensor(g)).numpy()
    nb = want.shape[0]
    np.testing.assert_allclose(got[:nb], want[:, :16], rtol=0, atol=2e-4 * np.abs(want).max())
    exact = _suffix_sums(rows[:, :16].astype(np.float64), g, look)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


def test_segsum_band_ids_above_f32_range():
    """Ids at and above 2^24 differ by one: compared as integers they stay
    apart (the JAX kernel compares them as f32)."""
    rows = torch.ones((6, 16))
    g = torch.tensor([2**24, 2**24 + 1, 2**24 + 1, 2**24 + 2, 2**24 + 3, 2**24 + 3], dtype=torch.int32)
    out = tseg.segsum_band(rows, g)
    np.testing.assert_array_equal(out[:, 0].numpy(), [1, 2, 1, 1, 2, 1])


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("max_opac", [0.3, 0.9])
def test_tiled_grads_match_jax_tiled(rng, max_opac):
    """All five inputs' gradients of the tiled rasterizer in both packages.
    The JAX backward's bf16 hi/lo scans and basis-moment conic gradient
    carry ~1e-4 relative error; stated bound atol 5e-4, rtol 2e-3 (the
    JAX package's own tiled-vs-oracle bound)."""
    scene = _scene(rng, max_opac=max_opac, big=max_opac > 0.5)
    g_img = _loss_weights(rng)
    want = _jax_grads(scene, g_img, tiled=True)
    got = _torch_grads(scene, g_img, tiled=True)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-3, err_msg=name)
    assert np.abs(got[4]).max() > 0


@pytest.mark.parametrize("max_opac", [0.3, 0.9])
def test_oracle_grads_match_jax_oracle(rng, max_opac):
    """The hand-derived oracle backward in both packages: the same chunked
    formulas in f32, so only summation order differs (1e-5 relative)."""
    scene = _scene(rng, max_opac=max_opac, big=max_opac > 0.5)
    g_img = _loss_weights(rng)
    want = _jax_grads(scene, g_img, tiled=False)
    got = _torch_grads(scene, g_img, tiled=False)
    for name, a, b in zip(NAMES, got, want):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_tiled_grads_match_oracle(rng):
    """The port's tiled gradient against its own oracle at opacity <= 0.3,
    where binning drops nothing above the 1/255 threshold: atol 5e-4,
    rtol 2e-3, the JAX package's bound for the same comparison."""
    scene = _scene(rng, max_opac=0.3)
    g_img = _loss_weights(rng)
    tiled = _torch_grads(scene, g_img, tiled=True)
    oracle = _torch_grads(scene, g_img, tiled=False)
    for name, a, b in zip(NAMES, tiled, oracle):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-3, err_msg=name)


def test_truncated_capacity_gives_zero_gradient(rng):
    """A capacity below the binned count zeroes the rasterizer gradient (the
    group starts would misalign), as in the JAX package."""
    scene = _scene(rng, max_opac=0.6, big=True)
    g_img = _loss_weights(rng)
    got = _torch_grads(scene, g_img, tiled=True, isect_mult=0.5)
    want = _jax_grads(scene, g_img, tiled=True, isect_mult=0.5)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(a, 0.0, err_msg=name)
        np.testing.assert_array_equal(b, 0.0, err_msg=name)
    full = _torch_grads(scene, g_img, tiled=True, isect_mult=16)
    assert np.abs(full[0]).max() > 0


# ------------------------------------------------------------ tie repair
def test_white_background_tie_gradient_matches_jax(rng):
    """Pixels no Gaussian covers render exactly the white background, 1.0,
    where the [0, 1] clip ties: JAX passes half the gradient there, and so
    must the port (torch.clamp would pass all of it). The background's own
    gradient sums exactly those pixels' share."""
    from easy_gaussian_splatting_tpu.models import gaussians as jg
    from easy_gaussian_splatting_torch.models import gaussians as tg

    n, cap, h, w = 20, 32, 24, 32
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-0.3, 0.3, size=(n, 3))
    arrays = dict(
        means=means,
        log_scales=np.full((cap, 3), -2.5, np.float32),
        quats=np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (cap, 1)),
        sh_0=rng.normal(0.0, 0.5, size=(cap, 1, 3)).astype(np.float32),
        sh_rest=np.zeros((cap, 3, 3), np.float32),
        logit_opacities=np.full((cap,), 1.0, np.float32),
    )
    alive = np.arange(cap) < n
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    g_out = rng.normal(size=(h, w, 3)).astype(np.float32)

    def jloss(params, bg):
        out = j_render(params, jnp.asarray(alive), JCameraView(
            w2c=jnp.asarray(w2c), K=jnp.asarray(K), width=w, height=h),
            1, bg, jnp.zeros((cap, 2)))
        return jnp.sum(out.image * jnp.asarray(g_out)), out.image

    jparams = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    (_, j_img), (j_gp, j_gbg) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.ones(3)
    )

    tparams = tg.params_from_numpy(arrays, "cpu").map(lambda x: x.requires_grad_(True))
    bg = torch.ones(3, requires_grad=True)
    out = render(tparams, torch.as_tensor(alive), CameraView(
        w2c=torch.as_tensor(w2c), K=torch.as_tensor(K), width=w, height=h),
        1, bg, torch.zeros((cap, 2), requires_grad=True))
    (out.image * torch.as_tensor(g_out)).sum().backward()
    t_img = out.image.detach().numpy()
    np.testing.assert_allclose(t_img, np.asarray(j_img), atol=1e-5)
    tie = (t_img == 1.0).all(axis=-1)
    assert tie.mean() > 0.3  # the white background covers much of the frame
    # uncovered pixels alone contribute half their cotangent
    half = 0.5 * g_out[tie].sum(axis=0)
    np.testing.assert_allclose(np.asarray(j_gbg), bg.grad.numpy(), rtol=1e-5, atol=1e-4)
    assert np.abs(bg.grad.numpy() - half).max() < np.abs(half).max()
    for name in ("means", "log_scales", "quats", "sh_0", "sh_rest", "logit_opacities"):
        want = np.asarray(getattr(j_gp, name))
        got = getattr(tparams, name).grad.numpy()
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-5 * max(np.abs(want).max(), 1e-6), err_msg=name
        )


@pytest.mark.parametrize(
    "name, jfn, tfn",
    [
        ("maximum", lambda x: jnp.maximum(x, 0.0), lambda x: tclip.maximum(x, 0.0)),
        ("minimum", lambda x: jnp.minimum(x, 1.0), lambda x: tclip.minimum(x, 1.0)),
        ("clip", lambda x: jnp.clip(x, 0.0, 1.0), lambda x: tclip.clip(x, 0.0, 1.0)),
    ],
)
def test_clamp_helpers_split_ties_like_jax(name, jfn, tfn):
    """At a bound the JAX primitive passes half the gradient, off it all or
    none; the port's helpers do the same (torch.clamp passes all of it at
    a tie: the SH colour clamp at 0, the image clip at 0 and 1)."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * jnp.arange(1.0, 6.0)))(jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_(True)
    (tfn(t) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want, err_msg=name)
    assert 0.5 * np.arange(1.0, 6.0)[1 if name != "minimum" else 3] in want
