"""The multi-camera train step: the port's ``make_batched_train_step``
against its own sequential reference (B ``make_grad_fn`` calls, the mean
gradient summed in view order, B ``update_statistics``, one
``adam_update``) and against the JAX package's ``make_batched_train_step``
on the same numpy inputs. Both packages run the tiled renderer (the JAX
kernels in interpret mode, the port's through their plain versions on the
CPU); the sizes are those of ``tests/test_training.py``'s batched test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.models import gaussians as jg
from easy_gaussian_splatting_tpu.models import optimizer as jo
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.models import density as td
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.models import optimizer as to
from easy_gaussian_splatting_torch.models.render import CameraView
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer

H, W, B = 32, 48, 3
N, CAP, SH = 60, 64, 1
NAMES = tg.PARAM_NAMES
STATS = ("grad_norm_accum", "collecting_counts", "max_radii")
CFG = dict(renderer="tiled", tile_size=16, raster_chunk=32)
LR_MEANS = 1e-2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs():
    """60 Gaussians in 64 slots, three cameras at different distances and
    offsets, random targets (``tests/test_training.py``'s batched test)."""
    rng = np.random.default_rng(0)
    xyzs = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(N, 3)).astype(np.uint8)
    w2cs = np.stack([np.eye(4, dtype=np.float32) for _ in range(B)])
    for i in range(B):
        w2cs[i, 2, 3] = 4.0 + 0.3 * i
        w2cs[i, 0, 3] = 0.1 * i
    Ks = np.stack([np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)] * B)
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    masks = np.zeros((B, H, W), np.float32)
    return xyzs, rgbs, (w2cs, Ks, images, masks)


def _torch_state(xyzs, rgbs):
    state = tg.init_gaussian_state(xyzs, rgbs, sh_degree=SH, capacity=CAP, device="cpu")
    return state, to.init_adam_state(state.params)


def _lrs(cfg):
    return dict(means=LR_MEANS, log_scales=cfg.log_scales_lr, quats=cfg.quats_lr,
                sh_0=cfg.sh_0_lr, sh_rest=cfg.sh_rest_lr,
                logit_opacities=cfg.logit_opacities_lr)


def _sequential(cfg, state, adam, views, skips):
    """The reference: each view through ``make_grad_fn``, the gradients
    summed from zeros in view order and divided by B, the statistics updated
    view by view, one Adam update."""
    grad_fn = ttrainer.make_grad_fn(cfg, ttrainer.get_render_fn(cfg))
    total = state.params.map(torch.zeros_like)
    stats, lds = state.stats, []
    for i in range(B):
        g, a, ld, radii = grad_fn(state, *(torch.as_tensor(v[i]) for v in views),
                                  height=H, width=W, sh_degree=SH)
        stats = td.update_statistics(stats, radii, a, H, W)
        total = tg.GaussianParams(**{k: getattr(total, k) + getattr(g, k) for k in NAMES})
        lds.append(ld)
    grads = total.map(lambda x: x / float(B))
    params, adam = to.adam_update(state.params, grads, adam, _lrs(cfg), skips)
    return params, adam, stats, lds


@pytest.mark.parametrize("event", ["none", "densify", "reset"])
def test_batched_step_equals_sequential_reference(event):
    """Bit for bit on the CPU: the same operations in the same order. The
    step's skips are those of the single-camera step (a densify event skips
    every group's update, an opacity reset the opacities')."""
    xyzs, rgbs, views = _inputs()
    cfg = tconfig.config_from_dict(CFG)
    skip_all, skip_opac = event == "densify", event == "reset"
    skips = {k: skip_all or (skip_opac and k == "logit_opacities") for k in NAMES}
    state, adam = _torch_state(xyzs, rgbs)
    want_params, want_adam, want_stats, lds = _sequential(cfg, state, adam, views, skips)

    state, adam = _torch_state(xyzs, rgbs)
    step = ttrainer.make_batched_train_step(cfg, ttrainer.get_render_fn(cfg))
    got, got_adam, ld = step(state, adam, *(torch.as_tensor(v) for v in views), LR_MEANS,
                             True, skip_all, skip_opac, height=H, width=W, sh_degree=SH)
    for k in NAMES:
        torch.testing.assert_close(getattr(got.params, k), getattr(want_params, k), rtol=0, atol=0)
        torch.testing.assert_close(getattr(got_adam.mu, k), getattr(want_adam.mu, k), rtol=0, atol=0)
        torch.testing.assert_close(getattr(got_adam.nu, k), getattr(want_adam.nu, k), rtol=0, atol=0)
        assert int(got_adam.steps[k]) == int(want_adam.steps[k]) == int(not skips[k])
    for k in STATS:
        torch.testing.assert_close(getattr(got.stats, k), getattr(want_stats, k), rtol=0, atol=0)
    assert float(got.stats.collecting_counts.max()) == B  # every view added its observations
    # loss terms: the mean over views; isects: the worst view
    for k in ("l1", "ssim", "total"):
        torch.testing.assert_close(ld[k], torch.stack([d[k] for d in lds]).mean(), rtol=0, atol=0)
    views_isects = [int(ttrainer.get_render_fn(cfg)(
        state.params, state.alive,
        CameraView(torch.as_tensor(views[0][i]), torch.as_tensor(views[1][i]), W, H),
        SH, torch.zeros(3)).num_isects) for i in range(B)]
    assert len(set(views_isects)) > 1 and int(ld["isects"]) == max(views_isects)


def test_batched_step_without_stats_keeps_them():
    xyzs, rgbs, views = _inputs()
    cfg = tconfig.config_from_dict(CFG)
    state, adam = _torch_state(xyzs, rgbs)
    step = ttrainer.make_batched_train_step(cfg, ttrainer.get_render_fn(cfg))
    got, _, _ = step(state, adam, *(torch.as_tensor(v) for v in views), LR_MEANS,
                     False, False, False, height=H, width=W, sh_degree=SH)
    for k in STATS:
        assert not bool(getattr(got.stats, k).any()), k


def test_batched_step_matches_jax():
    """The port's batched step against the JAX package's on the same numpy
    inputs (tiled renderer on both sides). The loss terms agree within 1e-5
    relative, the statistics as in the single-camera parity test
    (``tests/test_torch_training.py``: counts equal, max radii within 1 ulp,
    the gradient-norm sums within 1e-3 relative L2), the first Adam moment
    (0.1 x the mean gradient) within 1e-3 relative L2 per parameter (the
    rasterizer gradients agree to the JAX backward's bf16 precision), and
    the parameters wherever the gradient clears 1e-3 of its group's largest:
    there the first Adam step moves both by ~lr * sign(g), and they agree
    within 1e-6 + 1e-3 * lr."""
    xyzs, rgbs, views = _inputs()
    jcfg = jconfig.config_from_dict(CFG)
    jmodel = jg.init_gaussian_state(xyzs, rgbs, sh_degree=SH, capacity=CAP)
    jm, ja, jld = jtrainer.make_batched_train_step(jcfg, jtrainer.get_render_fn(jcfg))(
        jmodel, jo.init_adam_state(jmodel.params), *(jnp.asarray(v) for v in views),
        np.float32(LR_MEANS), np.bool_(True), np.bool_(False), np.bool_(False),
        height=H, width=W, sh_degree=SH)

    tcfg = tconfig.config_from_dict(CFG)
    state, adam = _torch_state(xyzs, rgbs)
    tm, ta, tld = ttrainer.make_batched_train_step(tcfg, ttrainer.get_render_fn(tcfg))(
        state, adam, *(torch.as_tensor(v) for v in views), LR_MEANS, True, False, False,
        height=H, width=W, sh_degree=SH)

    assert set(tld) == set(jld) and int(tld["isects"]) == int(jld["isects"])
    for k in ("l1", "ssim", "total"):
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(_np(tm.stats.collecting_counts), _np(jm.stats.collecting_counts))
    np.testing.assert_allclose(_np(tm.stats.max_radii), _np(jm.stats.max_radii), rtol=2e-7)
    a, b = _np(tm.stats.grad_norm_accum), _np(jm.stats.grad_norm_accum)
    assert np.linalg.norm(a - b) < 1e-3 * np.linalg.norm(b)
    lrs = _lrs(tcfg)
    for k in NAMES:
        mu_t, mu_j = _np(getattr(ta.mu, k)), _np(getattr(ja.mu, k))
        if not np.abs(mu_j).max() > 0:  # sh_rest at degree 1 beyond its bases
            np.testing.assert_array_equal(mu_t, mu_j, err_msg=k)
            continue
        assert np.linalg.norm(mu_t - mu_j) < 1e-3 * np.linalg.norm(mu_j), k
        g = np.abs(mu_j)
        clear = g > 1e-3 * g.max()
        assert clear.mean() > 0.5, (k, clear.mean())
        np.testing.assert_allclose(_np(getattr(tm.params, k))[clear],
                                   _np(getattr(jm.params, k))[clear],
                                   rtol=0, atol=1e-6 + 1e-3 * lrs[k], err_msg=k)
        assert int(ta.steps[k]) == int(ja.steps[k]) == 1
