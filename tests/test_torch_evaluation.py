"""Evaluation parity: the port's PSNR, SSIM, proxy LPIPS and ``Evaluator``
against the JAX package's on the same images and the same model (JAX on the
CPU, its Pallas kernels interpreted; the port's kernels through their plain
versions)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.evaluation import evaluator as jev
from easy_gaussian_splatting_tpu.evaluation import lpips as jlpips
from easy_gaussian_splatting_tpu.evaluation import metrics as jmetrics
from easy_gaussian_splatting_tpu.models import gaussians as jg
from easy_gaussian_splatting_tpu.scene.scene import Scene as JScene
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.evaluation import evaluator as tev
from easy_gaussian_splatting_torch.evaluation import lpips as tlpips
from easy_gaussian_splatting_torch.evaluation import metrics as tmetrics
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.scene.scene import Scene as TScene
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from test_torch_scene import write_blender


def _pair(rng, h=40, w=56):
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match_jax(rng):
    """f32 in both packages: 1e-5 dB on PSNR, 1e-6 relative on SSIM."""
    a, b = _pair(rng)
    np.testing.assert_allclose(float(tmetrics.psnr(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tmetrics.ssim(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert float(tmetrics.psnr(torch.as_tensor(a), torch.as_tensor(a))) == pytest.approx(120.0)


def test_proxy_lpips_matches_jax(rng):
    """The seeded proxy weights are the JAX package's bit for bit; the
    distance agrees to 1e-5 relative (f32 convolutions summed in another
    order), is zero on equal images and grows with the noise."""
    tw, jw = tlpips.proxy_weights(), jlpips.proxy_weights()
    assert tw.keys() == jw.keys()
    for k in tw:
        np.testing.assert_array_equal(tw[k], jw[k], err_msg=k)
    a, b = _pair(rng, 48, 64)
    metric = tlpips.LPIPS("proxy", tw)
    want = float(jlpips.build_lpips_device_fn(jw)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(metric(a, b), want, rtol=1e-5)
    assert metric(a, a) == 0.0
    c = np.clip(a + rng.normal(0, 0.3, size=a.shape), 0, 1).astype(np.float32)
    assert metric(a, c) > metric(a, b) > 0


def test_lpips_weights_from_the_environment(rng, tmp_path, monkeypatch):
    """A weights file named by EGS_TORCH_LPIPS_WEIGHTS (the JAX package's
    file format) is read and reported as ``vgg``; a missing path raises."""
    weights = jlpips.proxy_weights(seed=3)
    weights["lin2_w"] = np.abs(rng.normal(size=256)).astype(np.float32)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **weights)
    monkeypatch.delenv("EGS_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv(tlpips.WEIGHTS_ENV, str(path))
    tlpips.get_lpips.cache_clear()
    try:
        metric = tlpips.get_lpips()
        assert metric.kind == "vgg"
        a, b = _pair(rng, 32, 32)
        want = float(jlpips.build_lpips_device_fn(weights)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(metric(a, b), want, rtol=1e-5)
        monkeypatch.setenv(tlpips.WEIGHTS_ENV, str(tmp_path / "missing.npz"))
        tlpips.get_lpips.cache_clear()
        with pytest.raises(FileNotFoundError, match="EGS_TORCH_LPIPS_WEIGHTS"):
            tlpips.get_lpips()
    finally:
        tlpips.get_lpips.cache_clear()


def _model_arrays(rng, cap=96, n=80):
    arrays = dict(
        means=rng.uniform(-1.2, 1.2, size=(cap, 3)).astype(np.float32),
        log_scales=rng.uniform(-2.8, -1.6, size=(cap, 3)).astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        sh_0=rng.normal(0.0, 0.8, size=(cap, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(0.0, 0.2, size=(cap, 15, 3)).astype(np.float32),
        logit_opacities=rng.normal(0.0, 1.5, size=(cap,)).astype(np.float32),
    )
    return arrays, np.arange(cap) < n


def test_evaluator_matches_jax(rng, tmp_path):
    """One model, one Blender scene (eval frames of the test and val
    splits, masks on): the same keys, PSNR within 1e-3 dB, SSIM within
    1e-5, the proxy LPIPS within 1e-4 relative and the same side-by-side
    frames drawn (one ``random.sample``)."""
    root = write_blender(tmp_path / "data")
    arrays, alive = _model_arrays(rng)
    base = dict(renderer="tiled", tile_size=16, white_background=True, sh_degree=3)
    scene_args = (str(root), "blender", None, 9, True, 0.125, True, True, True, 1, True)
    out = {}
    for name in ("jax", "torch"):
        np.random.seed(0)
        if name == "jax":
            cfg = jconfig.config_from_dict(base)
            scene = JScene(*scene_args, blender_init_points=10)
            model = jg.GaussianModelState(
                params=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                alive=jnp.asarray(alive), stats=jg.zero_stats(alive.shape[0]))
            ev = jev.Evaluator(2, jtrainer.get_render_fn(cfg))
            bg = jnp.ones((3,), jnp.float32)
        else:
            cfg = tconfig.config_from_dict(base)
            scene = TScene(*scene_args, blender_init_points=10)
            model = tg.GaussianModelState(params=tg.params_from_numpy(arrays, "cpu"),
                                          alive=torch.as_tensor(alive),
                                          stats=tg.zero_stats(alive.shape[0], "cpu"))
            ev = tev.Evaluator(2, ttrainer.get_render_fn(cfg))
            bg = torch.ones(3)
        random.seed(9)
        out[name] = ev.evaluate(scene, "eval", model, 3, bg, num_workers=0)
    t, j = out["torch"], out["jax"]
    assert set(t) == set(j) and {"lpips_proxy", "render_2", "latency_device_ms"} <= set(t)
    assert abs(t["psnr"] - j["psnr"]) < 1e-3 and 10 < t["psnr"] < 40
    np.testing.assert_allclose(t["ssim"], j["ssim"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["lpips_proxy"], j["lpips_proxy"], rtol=1e-4)
    for k in ("render_1", "render_2"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=0, atol=1e-4)
    assert all(t[k] > 0 for k in ("fps", "latency_ms", "latency_device_ms"))
