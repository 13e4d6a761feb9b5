"""Training parity: the port's loss, Adam, density control, gradients, train
step, checkpoints and train() loop against the JAX package's, on the same
numpy inputs (Pallas kernels in interpret mode, the port's kernels through
their plain versions on the CPU)."""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.models import density as jd
from easy_gaussian_splatting_tpu.models import gaussians as jg
from easy_gaussian_splatting_tpu.models import loss as jl
from easy_gaussian_splatting_tpu.models import optimizer as jo
from easy_gaussian_splatting_tpu.ops import lr_schedule as jlr
from easy_gaussian_splatting_tpu.ops import ssim as jssim
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_tpu.utils import checkpoint as jckpt
from easy_gaussian_splatting_torch.models import density as td
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.models import loss as tl
from easy_gaussian_splatting_torch.models import optimizer as to
from easy_gaussian_splatting_torch.ops import lr_schedule as tlr
from easy_gaussian_splatting_torch.ops import ssim as tssim
from easy_gaussian_splatting_torch.scene.scene import prefetch_frames
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.utils import checkpoint as tckpt

H, W = 32, 48
CAP, N = 64, 60
NAMES = tg.PARAM_NAMES
CFG = dict(
    renderer="tiled", tile_size=16, white_background=True, lambda_ssim=0.2,
    sh_degree=3, sh_degree_interval=0, data_device_cache=False, dataloader_workers=0,
)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scene_arrays(rng):
    """A 60-Gaussian SH-3 model in a 64-slot buffer, a camera looking at it
    and a target image."""
    means = rng.uniform(-0.8, 0.8, size=(CAP, 3)).astype(np.float32)
    arrays = dict(
        means=means,
        log_scales=rng.uniform(-3.0, -1.8, size=(CAP, 3)).astype(np.float32),
        quats=rng.normal(size=(CAP, 4)).astype(np.float32),
        sh_0=rng.normal(0.0, 0.8, size=(CAP, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(0.0, 0.2, size=(CAP, 15, 3)).astype(np.float32),
        logit_opacities=rng.normal(0.0, 1.5, size=(CAP,)).astype(np.float32),
    )
    alive = np.arange(CAP) < N
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.1, 4.0]
    K = np.array([[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]], np.float32)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    return arrays, alive, w2c, K, image, mask


def _jstate(arrays, alive, stats=None):
    params = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    st = jg.zero_stats(CAP) if stats is None else jg.DensifyStats(
        **{k: jnp.asarray(v) for k, v in stats.items()})
    return jg.GaussianModelState(params=params, alive=jnp.asarray(alive), stats=st)


def _tstate(arrays, alive, stats=None):
    st = tg.zero_stats(CAP, "cpu") if stats is None else tg.DensifyStats(
        **{k: torch.as_tensor(v) for k, v in stats.items()})
    return tg.GaussianModelState(
        params=tg.params_from_numpy(arrays, "cpu"), alive=torch.as_tensor(alive), stats=st
    )


def _adam_arrays(rng, steps=3):
    mu = {k: rng.normal(0, 1e-3, size=v.shape).astype(np.float32)
          for k, v in _scene_arrays(np.random.default_rng(1))[0].items()}
    nu = {k: rng.uniform(0, 1e-5, size=v.shape).astype(np.float32) for k, v in mu.items()}
    return mu, nu, {k: steps for k in NAMES}


def _jadam(mu, nu, steps):
    return jo.AdamState(
        mu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
        steps={k: jnp.asarray(v, jnp.int32) for k, v in steps.items()},
    )


def _tadam(mu, nu, steps):
    return to.AdamState(
        mu=tg.params_from_numpy(mu, "cpu"), nu=tg.params_from_numpy(nu, "cpu"),
        steps={k: torch.tensor(v, dtype=torch.int32) for k, v in steps.items()},
    )


def _assert_tree(got, want, names, **tol):
    for k in names:
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(want, k)), err_msg=k, **tol)


# ------------------------------------------------------------------ loss
def test_ssim_value_and_gradient_match_jax(rng):
    """f32 banded-matrix blurs in both packages: 1e-6 on the value, 1e-5
    of the largest gradient."""
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, 1).astype(np.float32)
    jv, jgr = jax.value_and_grad(lambda x: jssim.ssim(jnp.asarray(a), x))(jnp.asarray(b))
    tb = torch.as_tensor(b).requires_grad_(True)
    tv = tssim.ssim(torch.as_tensor(a), tb)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(tb.grad), _np(jgr), rtol=0, atol=1e-5 * np.abs(_np(jgr)).max())


@pytest.mark.parametrize("scale_reg", [False, True])
def test_loss_dict_and_gradients_match_jax(rng, scale_reg):
    """Mask compositing, L1 + SSIM and the scale regularizer: values to
    1e-6 relative, gradients to 1e-5 of the largest."""
    render_img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) < 0.2).astype(np.float32)
    log_scales = rng.normal(-2, 1.0, size=(CAP, 3)).astype(np.float32)
    alive = np.arange(CAP) < N
    kw = dict(use_scale_regularization=scale_reg, max_scale_ratio=3.0, lambda_scale=0.1)

    def jloss(img, ls):
        ld = jl.loss_dict(img, jnp.asarray(gt), jnp.asarray(mask), 0.2,
                          log_scales=ls, alive=jnp.asarray(alive), **kw)
        return ld["total"], ld

    (_, jld), (jg_img, jg_ls) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(render_img), jnp.asarray(log_scales))
    t_img = torch.as_tensor(render_img).requires_grad_(True)
    t_ls = torch.as_tensor(log_scales).requires_grad_(True)
    tld = tl.loss_dict(t_img, torch.as_tensor(gt), torch.as_tensor(mask), 0.2,
                       log_scales=t_ls, alive=torch.as_tensor(alive), **kw)
    tld["total"].backward()
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(t_img.grad), _np(jg_img), rtol=0,
                               atol=1e-5 * np.abs(_np(jg_img)).max())
    if scale_reg:
        np.testing.assert_allclose(_np(t_ls.grad), _np(jg_ls), rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(_np(t_img.grad)[mask > 0], 0.0)


def test_lr_schedule_matches_jax():
    js = jlr.log_lerp_schedule(1e-3, 1e-5, 3000)
    ts = tlr.log_lerp_schedule(1e-3, 1e-5, 3000)
    for step in (0, 1, 10, 1500, 2999, 3000, 5000):
        assert ts(step) == js(step)


# ------------------------------------------------------------------ adam
def test_adam_update_with_skips_matches_jax(rng):
    """Identical parameters, gradients and moments: one step with the
    opacity group skipped, then one with all groups. f32 in both packages,
    bias corrections in f32 on the step: 2 ulps."""
    arrays = _scene_arrays(rng)[0]
    grads = {k: rng.normal(0, 1e-3, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    mu, nu, steps = _adam_arrays(rng)
    lrs = {"means": np.float32(1.6e-4), "log_scales": 0.005, "quats": 0.001,
           "sh_0": 0.0025, "sh_rest": 0.000125, "logit_opacities": 0.05}
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jgr = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in grads.items()})
    tp = tg.params_from_numpy(arrays, "cpu")
    tgr = tg.params_from_numpy(grads, "cpu")
    ja, ta = _jadam(mu, nu, steps), _tadam(mu, nu, steps)
    for skip_opac in (True, False):
        jskips = {k: jnp.asarray(skip_opac and k == "logit_opacities") for k in NAMES}
        tskips = {k: skip_opac and k == "logit_opacities" for k in NAMES}
        jp, ja = jo.adam_update(jp, jgr, ja, {k: jnp.float32(v) for k, v in lrs.items()}, jskips)
        tp, ta = to.adam_update(tp, tgr, ta, lrs, tskips)
        _assert_tree(tp, jp, NAMES, rtol=2e-7, atol=0)
        _assert_tree(ta.mu, ja.mu, NAMES, rtol=2e-7, atol=1e-12)
        _assert_tree(ta.nu, ja.nu, NAMES, rtol=2e-7, atol=1e-15)
        assert {k: int(v) for k, v in ta.steps.items()} == {k: int(v) for k, v in ja.steps.items()}
    assert int(ta.steps["logit_opacities"]) == 4 and int(ta.steps["means"]) == 5


# --------------------------------------------------------------- density
def _stats_arrays(rng):
    return dict(
        grad_norm_accum=rng.uniform(0, 2e-3, size=CAP).astype(np.float32) * 3,
        collecting_counts=np.full(CAP, 3.0, np.float32),
        max_radii=rng.uniform(0, 0.2, size=CAP).astype(np.float32),
    )


def test_update_statistics_matches_jax(rng):
    stats = _stats_arrays(rng)
    radii = np.where(rng.uniform(size=CAP) < 0.3, 0.0, rng.uniform(1, 30, size=CAP)).astype(np.float32)
    absgrad = rng.uniform(0, 1e-3, size=(CAP, 2)).astype(np.float32)
    j = jd.update_statistics(_jstate(*_scene_arrays(rng)[:2], stats).stats,
                             jnp.asarray(radii), jnp.asarray(absgrad), H, W)
    t = td.update_statistics(tg.DensifyStats(**{k: torch.as_tensor(v) for k, v in stats.items()}),
                             torch.as_tensor(radii), torch.as_tensor(absgrad), H, W)
    _assert_tree(t, j, ("grad_norm_accum", "collecting_counts", "max_radii"), rtol=1e-6, atol=0)


@pytest.mark.parametrize("capacity_room", ["fits", "overflows"])
def test_densify_and_prune_matches_jax(rng, capacity_room):
    """One refine event fed the JAX package's own split noise: alive set,
    parameters, Adam moments and the info dict equal (the split offset is a
    3-term rotation sum, 1e-6)."""
    arrays, alive, *_ = _scene_arrays(rng)
    arrays["log_scales"][:20] = np.log(0.8)  # big: these split
    arrays["logit_opacities"][50:53] = -8.0  # low opacity: pruned
    stats = _stats_arrays(rng)
    if capacity_room == "overflows":  # every Gaussian clones or splits
        alive = np.ones(CAP, bool)
        stats["grad_norm_accum"][:] = 1.0
    mu, nu, steps = _adam_arrays(rng)
    dcfg = dict(densify_grad_thresh=0.0015, densify_scale_thresh=0.5, num_splits=2,
                prune_radii_ratio_thresh=0.15, prune_scale_thresh=1.0, min_opacity=0.005)
    key = jax.random.PRNGKey(3)
    js, ja, jinfo, jover = jd.densify_and_prune(
        _jstate(arrays, alive, stats), _jadam(mu, nu, steps), key, jd.DensifyConfig(**dcfg))
    noise = torch.as_tensor(np.array(jax.random.normal(key, (CAP, 3), jnp.float32)))
    ts, ta, tinfo, tover = td.densify_and_prune(
        _tstate(arrays, alive, stats), _tadam(mu, nu, steps), None, td.DensifyConfig(**dcfg),
        noise=noise)
    assert bool(tover) == bool(jover) == (capacity_room == "overflows")
    assert {k: int(v) for k, v in tinfo.items()} == {k: int(v) for k, v in jinfo.items()}
    assert int(tinfo["split"]) > 0 and int(tinfo["clone"]) > 0
    np.testing.assert_array_equal(_np(ts.alive), _np(js.alive))
    _assert_tree(ts.params, js.params, NAMES, rtol=1e-6, atol=1e-6)
    _assert_tree(ta.mu, ja.mu, NAMES, rtol=0, atol=0)
    _assert_tree(ta.nu, ja.nu, NAMES, rtol=0, atol=0)
    np.testing.assert_array_equal(_np(ts.stats.grad_norm_accum), 0.0)


def test_densify_draws_noise_from_the_generator(rng):
    """Without explicit noise the split samples come from the generator:
    the same seed gives the same event."""
    arrays, alive, *_ = _scene_arrays(rng)
    arrays["log_scales"][:20] = np.log(0.8)
    stats = _stats_arrays(rng)
    mu, nu, steps = _adam_arrays(rng)
    dcfg = td.DensifyConfig(0.0015, 0.5, 2, 0.15, 1.0, 0.005)
    outs = [
        td.densify_and_prune(_tstate(arrays, alive, stats), _tadam(mu, nu, steps),
                             torch.Generator().manual_seed(7), dcfg)[0].params.means
        for _ in range(2)
    ]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_reset_opacities_matches_jax(rng):
    arrays, alive, *_ = _scene_arrays(rng)
    mu, nu, steps = _adam_arrays(rng)
    js, ja = jd.reset_opacities(_jstate(arrays, alive), _jadam(mu, nu, steps), 0.005)
    ts, ta = td.reset_opacities(_tstate(arrays, alive), _tadam(mu, nu, steps), 0.005)
    np.testing.assert_allclose(_np(ts.params.logit_opacities), _np(js.params.logit_opacities),
                               rtol=1e-6)
    _assert_tree(ta.mu, ja.mu, NAMES, rtol=0, atol=0)
    np.testing.assert_array_equal(_np(ta.nu.logit_opacities), 0.0)


def test_grow_capacity_and_adam_match_jax(rng):
    arrays, alive, *_ = _scene_arrays(rng)
    stats = _stats_arrays(rng)
    mu, nu, steps = _adam_arrays(rng)
    js = jg.grow_capacity(_jstate(arrays, alive, stats), 96)
    ts = tg.grow_capacity(_tstate(arrays, alive, stats), 96)
    assert ts.capacity == js.capacity == 96
    _assert_tree(ts.params, js.params, NAMES, rtol=0, atol=0)
    _assert_tree(ts.stats, js.stats, ("grad_norm_accum", "collecting_counts", "max_radii"),
                 rtol=0, atol=0)
    np.testing.assert_array_equal(_np(ts.alive), _np(js.alive))
    ja = jo.grow_adam_state(_jadam(mu, nu, steps), 32)
    ta = to.grow_adam_state(_tadam(mu, nu, steps), 32)
    _assert_tree(ta.nu, ja.nu, NAMES, rtol=0, atol=0)
    perm = np.random.default_rng(2).permutation(96)[:64]
    _assert_tree(to.permute_adam_state(ta, torch.as_tensor(perm)).mu,
                 jo.permute_adam_state(ja, jnp.asarray(perm)).mu, NAMES, rtol=0, atol=0)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_with_adam_state_each_way(rng, tmp_path, writer):
    arrays, alive, *_ = _scene_arrays(rng)
    mu, nu, steps = _adam_arrays(rng, steps=17)
    path = tmp_path / "checkpoints" / "iterations_17.npz"
    if writer == "jax":
        jckpt.save_checkpoint(path, _jstate(arrays, alive), 2, 17, adam=_jadam(mu, nu, steps))
        state, sh, step, adam = tckpt.load_checkpoint(path, device="cpu")
    else:
        tckpt.save_checkpoint(path, _tstate(arrays, alive), 2, 17, adam=_tadam(mu, nu, steps))
        state, sh, step, adam = jckpt.load_checkpoint(path)
    assert (sh, step) == (2, 17) and adam is not None
    for k in NAMES:
        np.testing.assert_array_equal(_np(getattr(state.params, k)), arrays[k])
        np.testing.assert_array_equal(_np(getattr(adam.mu, k)), mu[k])
        np.testing.assert_array_equal(_np(getattr(adam.nu, k)), nu[k])
    assert {k: int(v) for k, v in adam.steps.items()} == steps
    np.testing.assert_array_equal(_np(state.alive), alive)


# -------------------------------------------------------- gradients, step
def _grads_both(rng, renderer="tiled"):
    arrays, alive, w2c, K, image, mask = _scene_arrays(rng)
    jcfg = jconfig.config_from_dict(dict(CFG, renderer=renderer))
    tcfg = tconfig.config_from_dict(dict(CFG, renderer=renderer))
    jf = jtrainer.make_grad_fn(jcfg, jtrainer.get_render_fn(jcfg))
    tf = ttrainer.make_grad_fn(tcfg, ttrainer.get_render_fn(tcfg))
    kw = dict(height=H, width=W, sh_degree=3)
    jout = jf(_jstate(arrays, alive), *(jnp.asarray(x) for x in (w2c, K, image, mask)), **kw)
    tout = tf(_tstate(arrays, alive), *(torch.as_tensor(x) for x in (w2c, K, image, mask)), **kw)
    return jout, tout


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_make_grad_fn_matches_jax(rng):
    """Pre-Adam gradients of the tiled single-camera step, absgrad and
    radii. Projection and SH agree to a few ulps and the rasterizer
    gradients to the JAX backward's bf16-scan precision (~1e-4), so each
    parameter's gradient agrees to 1e-3 relative L2 error."""
    (jgrads, jabs, jld, jradii), (tgrads, tabs, tld, tradii) = _grads_both(rng)
    np.testing.assert_array_equal(_np(tradii), _np(jradii))
    for k in ("l1", "ssim", "total"):
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=1e-5, err_msg=k)
    for k in NAMES:
        a, b = _np(getattr(tgrads, k)), _np(getattr(jgrads, k))
        assert np.abs(b).max() > 0, k
        assert _rel_l2(a, b) < 1e-3, (k, _rel_l2(a, b))
    assert _rel_l2(_np(tabs), _np(jabs)) < 1e-3
    np.testing.assert_array_equal(_np(tabs)[N:], 0.0)


def test_train_step_matches_jax(rng):
    """One train step from the same state: the loss dict and statistics
    agree, and so do the parameters wherever the gradient clears a floor.
    On the first step Adam moves each parameter by ~lr * sign(g), so where
    |g| is rounding noise the two packages may move it by up to 2 * lr in
    opposite directions; above 1e-3 of the group's largest |g| they agree
    to 1e-6 plus 1e-3 * lr."""
    arrays, alive, w2c, K, image, mask = _scene_arrays(rng)
    jcfg = jconfig.config_from_dict(CFG)
    tcfg = tconfig.config_from_dict(CFG)
    kw = dict(height=H, width=W, sh_degree=3)
    jm, ja, jld = jtrainer.make_train_step(jcfg, jtrainer.get_render_fn(jcfg))(
        _jstate(arrays, alive), jo.init_adam_state(_jstate(arrays, alive).params),
        *(jnp.asarray(x) for x in (w2c, K, image, mask)),
        np.float32(1e-3), np.bool_(True), np.bool_(False), np.bool_(False), **kw)
    ts = _tstate(arrays, alive)
    tm, ta, tld = ttrainer.make_train_step(tcfg, ttrainer.get_render_fn(tcfg))(
        ts, to.init_adam_state(ts.params),
        *(torch.as_tensor(x) for x in (w2c, K, image, mask)), 1e-3, True, False, False, **kw)
    assert set(tld) == set(jld) and int(tld["isects"]) == int(jld["isects"])
    for k in ("l1", "ssim", "total"):
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(_np(tm.stats.collecting_counts), _np(jm.stats.collecting_counts))
    # XLA may divide by max(H, W) as a multiply by its reciprocal: 1 ulp
    np.testing.assert_allclose(_np(tm.stats.max_radii), _np(jm.stats.max_radii), rtol=2e-7)
    assert _rel_l2(_np(tm.stats.grad_norm_accum), _np(jm.stats.grad_norm_accum)) < 1e-3
    lrs = dict(means=1e-3, log_scales=tcfg.log_scales_lr, quats=tcfg.quats_lr,
               sh_0=tcfg.sh_0_lr, sh_rest=tcfg.sh_rest_lr, logit_opacities=tcfg.logit_opacities_lr)
    for k in NAMES:
        g = np.abs(_np(getattr(ta.mu, k))) / 0.1  # mu after one step is 0.1 * g
        clear = g > 1e-3 * g.max()
        assert clear.mean() > 0.5, k
        a, b = _np(getattr(tm.params, k)), _np(getattr(jm.params, k))
        np.testing.assert_allclose(a[clear], b[clear], rtol=0, atol=1e-6 + 1e-3 * lrs[k], err_msg=k)
        assert int(ta.steps[k]) == int(ja.steps[k]) == 1


# (do_stats, skip_all, skip_opac): the four inside the refine window, and a
# step outside it
STEP_FLAGS = [(True, False, False), (True, True, False), (True, False, True),
              (True, True, True), (False, False, False)]
_JAX_STEP = {}


@pytest.mark.parametrize("flags", STEP_FLAGS)
def test_train_step_with_traced_flags_matches_jax(rng, flags):
    """The port's step with ``lr_means`` and the three flags as 0-d tensors
    (the inputs of its captured program) against the JAX package's jitted
    step with its flags traced (one program for every combination), at
    ``test_train_step_matches_jax``'s tolerances, and bit for bit against
    the port's step with host values. A skipped group keeps its parameter,
    moments and step count in both packages; the statistics move only
    inside the refine window."""
    arrays, alive, w2c, K, image, mask = _scene_arrays(rng)
    stats0 = {k: np.random.default_rng(i).uniform(0, 2, size=CAP).astype(np.float32)
              for i, k in enumerate(("grad_norm_accum", "collecting_counts", "max_radii"))}
    jcfg = jconfig.config_from_dict(CFG)
    tcfg = tconfig.config_from_dict(CFG)
    kw = dict(height=H, width=W, sh_degree=3)
    if "step" not in _JAX_STEP:
        _JAX_STEP["step"] = jtrainer.make_train_step(jcfg, jtrainer.get_render_fn(jcfg))
    jstate = _jstate(arrays, alive, stats0)
    jm, ja, jld = _JAX_STEP["step"](
        jstate, jo.init_adam_state(jstate.params),
        *(jnp.asarray(x) for x in (w2c, K, image, mask)),
        np.float32(1e-3), *(np.bool_(f) for f in flags), **kw)
    tstep = ttrainer.make_train_step(tcfg, ttrainer.get_render_fn(tcfg))
    frame = [torch.as_tensor(x) for x in (w2c, K, image, mask)]
    outs = []
    for lr, fl in ((torch.tensor(1e-3), [torch.tensor(f) for f in flags]), (1e-3, list(flags))):
        ts = _tstate(arrays, alive, stats0)
        outs.append(tstep(ts, to.init_adam_state(ts.params), *frame, lr, *fl, **kw))
    (tm, ta, tld), (hm, ha, hld) = outs
    for k in NAMES:  # bit for bit against the host flags
        for got, want in ((tm.params, hm.params), (ta.mu, ha.mu), (ta.nu, ha.nu)):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        assert torch.equal(ta.steps[k], ha.steps[k]), k
    for k in ("grad_norm_accum", "collecting_counts", "max_radii"):
        assert torch.equal(getattr(tm.stats, k), getattr(hm.stats, k)), k
    assert set(tld) == set(hld) and all(torch.equal(tld[k], hld[k]) for k in tld)

    do_stats, skip_all, skip_opac = flags
    assert set(tld) == set(jld) and int(tld["isects"]) == int(jld["isects"])
    for k in ("l1", "ssim", "total"):
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(_np(tm.stats.collecting_counts), _np(jm.stats.collecting_counts))
    np.testing.assert_allclose(_np(tm.stats.max_radii), _np(jm.stats.max_radii), rtol=2e-7)
    assert _rel_l2(_np(tm.stats.grad_norm_accum), _np(jm.stats.grad_norm_accum)) < 1e-3
    if not do_stats:
        for k, v in stats0.items():
            np.testing.assert_array_equal(_np(getattr(tm.stats, k)), v, err_msg=k)
    lrs = dict(means=1e-3, log_scales=tcfg.log_scales_lr, quats=tcfg.quats_lr,
               sh_0=tcfg.sh_0_lr, sh_rest=tcfg.sh_rest_lr, logit_opacities=tcfg.logit_opacities_lr)
    for k in NAMES:
        a, b = _np(getattr(tm.params, k)), _np(getattr(jm.params, k))
        skipped = skip_all or (skip_opac and k == "logit_opacities")
        assert int(ta.steps[k]) == int(ja.steps[k]) == (0 if skipped else 1), k
        if skipped:
            np.testing.assert_array_equal(a, arrays[k], err_msg=k)
            np.testing.assert_array_equal(b, arrays[k], err_msg=k)
            np.testing.assert_array_equal(_np(getattr(ta.mu, k)), 0.0, err_msg=k)
            continue
        g = np.abs(_np(getattr(ta.mu, k))) / 0.1  # mu after one step is 0.1 * g
        clear = g > 1e-3 * g.max()
        assert clear.mean() > 0.5, k
        np.testing.assert_allclose(a[clear], b[clear], rtol=0, atol=1e-6 + 1e-3 * lrs[k], err_msg=k)


# ------------------------------------------------------------------ train
class _OneCameraScene:
    """The JAX ``Scene``'s interface over one in-memory frame."""

    def __init__(self, xyzs, rgbs, frame, n_train):
        self.pc = SimpleNamespace(xyzs=xyzs, rgbs=rgbs, nbr_points=xyzs.shape[0])
        self.frame, self.n = frame, n_train

    def nbr_data(self, split):
        return self.n if split == "train" else 0

    def get_data(self, split, index):
        return dict(self.frame)


def test_prefetch_frames_order_and_shuffle():
    scene = SimpleNamespace(nbr_data=lambda s: 7, get_data=lambda s, i: i)
    assert list(prefetch_frames(scene, "train", num_workers=2)) == list(range(7))
    random.seed(3)
    want = list(range(7))
    random.shuffle(want)
    random.seed(3)
    assert list(prefetch_frames(scene, "train", shuffle=True, num_workers=0)) == want


def test_train_loop_matches_jax(rng, monkeypatch):
    """Three steps of both train() loops on a one-camera scene with the
    refine window open but no event: per-step losses and the final
    statistics. Adam's first steps amplify gradient rounding into ~lr
    parameter moves (see test_train_step_matches_jax), so losses are held
    to 1e-4 relative and the statistics to 1e-2 relative L2."""
    arrays, alive, w2c, K, image, mask = _scene_arrays(rng)
    xyzs = rng.uniform(-0.6, 0.6, size=(N, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(N, 3)).astype(np.uint8)
    frame = dict(K=K, height=H, width=W, w2c=w2c, image=image, mask=mask)
    sched = dict(CFG, total_iterations=3, refine_start=0, refine_every=1000,
                 reset_opacities_every=1000, initial_capacity=CAP, log_every=1)
    losses = {"jax": [], "torch": []}

    def recording(mod, name):
        orig = mod.make_train_step

        def make(cfg, render_fn):
            step = orig(cfg, render_fn)

            def run(*a, **k):
                out = step(*a, **k)
                losses[name].append(float(out[2]["total"]))
                return out

            return run

        monkeypatch.setattr(mod, "make_train_step", make)

    recording(jtrainer, "jax")
    recording(ttrainer, "torch")
    random.seed(0)
    jloop = jtrainer.train(jconfig.config_from_dict(sched), scene=_OneCameraScene(xyzs, rgbs, frame, 3))
    random.seed(0)
    tloop = ttrainer.train(tconfig.config_from_dict(sched), scene=_OneCameraScene(xyzs, rgbs, frame, 3),
                           device="cpu")
    assert tloop.step == jloop.step == 3
    assert len(losses["torch"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4)
    for k in ("grad_norm_accum", "collecting_counts", "max_radii"):
        a, b = _np(getattr(tloop.model.stats, k)), _np(getattr(jloop.model.stats, k))
        assert _rel_l2(a, b) < 1e-2, (k, _rel_l2(a, b))
    np.testing.assert_array_equal(_np(tloop.model.alive), _np(jloop.model.alive))


def test_train_refuses_what_is_not_ported(rng, tmp_path, monkeypatch):
    """``mesh_shape`` refuses a shape that does not parse (``ValueError``,
    as the JAX trainer), a world that is not joined, and a device count
    other than the world's size; ``view_online`` with an output directory
    builds the training viewer and trains every step; ``view_online`` and
    ``profile_steps`` without an output directory are ignored, as the JAX
    trainer ignores them."""
    import torch.distributed as dist

    from easy_gaussian_splatting_torch.viewer import integration as tint
    from torch_parallel_worker import free_port

    arrays, alive, w2c, K, image, mask = _scene_arrays(rng)
    frame = dict(K=K, height=H, width=W, w2c=w2c, image=image, mask=mask)
    scene = _OneCameraScene(arrays["means"][:N], np.zeros((N, 3), np.uint8), frame, 3)
    base = dict(CFG, total_iterations=3)

    def mesh_train(shape):
        ttrainer.train(tconfig.config_from_dict(dict(base, mesh_shape=shape)), scene=scene,
                       device="cpu")

    for shape in ("tiles:x", "rows:2", "tiles:2:1", "gauss:0", "tiles"):
        with pytest.raises(ValueError, match="invalid mesh_shape"):
            mesh_train(shape)
    with pytest.raises(RuntimeError, match="initialised process group of 4 ranks"):
        mesh_train("tiles:4")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for shape in ("tiles:4", "gauss:2,tiles:2"):
            with pytest.raises(ValueError, match="needs a world of 4 ranks, have 1"):
                mesh_train(shape)
    finally:
        dist.destroy_process_group()
    viewers = []
    construct = tint.construct_training_viewer
    monkeypatch.setattr(tint, "construct_training_viewer", lambda loop, cfg, out: viewers.append(
        construct(loop, cfg, out, port=0)) or viewers[-1])
    (tmp_path / "cameras.json").write_text("[]")  # a Scene with an output directory writes it
    loop = ttrainer.train(tconfig.config_from_dict(dict(base, view_online=True,
                                                        output=str(tmp_path))),
                          scene=scene, device="cpu")
    assert loop.step == 3 and len(viewers) == 1 and viewers[0].in_training_mode
    for extra in (dict(view_online=True), dict(profile_steps=5)):
        loop = ttrainer.train(tconfig.config_from_dict(dict(base, **extra)), scene=scene, device="cpu")
        assert loop.step == 3
    assert len(viewers) == 1


# ------------------------------------------------- train() from a data path
def _generated_scene(tmp_path, fmt):
    """A generated scene: Blender 32x48 (48-pixel renders cut to their top 32
    rows; 3 train and 2 test frames) or COLMAP 32x32 (5 images)."""
    from PIL import Image

    from easy_gaussian_splatting_torch.utils import synthetic as tsyn

    root = tmp_path / fmt
    if fmt == "blender":
        tsyn.generate_blender_scene(root, n_train=3, n_test=2, image_size=48, n_gaussians=40,
                                    device="cpu")
        for png in root.glob("*/r_*.png"):
            Image.fromarray(np.asarray(Image.open(png))[:32]).save(png)
        return dict(data=str(root), data_format="blender", white_background=True,
                    eval_in_test=True, blender_init_points=150)
    tsyn.generate_colmap_scene(root, n_images=5, image_size=32, n_gaussians=40, n_points=150,
                               device="cpu")
    return dict(data=str(root), data_format="colmap", white_background=False, eval_split_ratio=0.4)


def _record_losses(monkeypatch, mod, into):
    orig = mod.make_train_step

    def make(cfg, render_fn):
        step = orig(cfg, render_fn)

        def run(*a, **k):
            out = step(*a, **k)
            into.append(float(out[2]["total"]))
            return out

        return run

    monkeypatch.setattr(mod, "make_train_step", make)


@pytest.mark.parametrize("fmt", ["blender", "colmap"])
def test_train_from_data_path_matches_jax(tmp_path, monkeypatch, fmt):
    """train(cfg) with no scene object, eval frames and the device frame
    cache on (the default) in both packages: the scene, its split, the
    frame order and the eval at step 1 follow the same draws, so the four
    steps' losses agree within 1e-4 relative (see test_train_loop_matches_jax)."""
    sched = dict(CFG, **_generated_scene(tmp_path, fmt), total_iterations=4, eval=True,
                 eval_every=1000, eval_render_num=1, refine_start=0, refine_every=1000,
                 reset_opacities_every=1000, initial_capacity=256, log_every=1)
    sched["data_device_cache"] = True
    losses = {"jax": [], "torch": []}
    _record_losses(monkeypatch, jtrainer, losses["jax"])
    _record_losses(monkeypatch, ttrainer, losses["torch"])
    from easy_gaussian_splatting_torch.evaluation import evaluator as tev

    evals = []
    orig_eval = tev.Evaluator.evaluate

    def evaluate(self, *a, **k):
        evals.append((k.get("cache"), orig_eval(self, *a, **k)))
        return evals[-1][1]

    monkeypatch.setattr(tev.Evaluator, "evaluate", evaluate)
    loops = {}
    for name, trainer, config in (("jax", jtrainer, jconfig), ("torch", ttrainer, tconfig)):
        random.seed(0)
        np.random.seed(0)
        kw = {} if name == "jax" else dict(device="cpu")
        loops[name] = trainer.train(config.config_from_dict(sched), **kw)
    assert loops["torch"].step == loops["jax"].step == 4
    assert len(losses["torch"]) == len(losses["jax"]) == 4
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4)
    assert len(evals) == 1 and evals[0][0] is not None  # step 1, from the eval cache
    assert np.isfinite(evals[0][1]["psnr"]) and "lpips_proxy" in evals[0][1]


def test_train_cache_on_and_off_give_the_same_losses(tmp_path, monkeypatch):
    """In the port, the device frame cache changes where a frame comes from,
    not which frame or what it holds: identical losses, bit for bit."""
    base = dict(CFG, **_generated_scene(tmp_path, "blender"), total_iterations=5, eval=True,
                eval_every=2, eval_render_num=1, refine_start=0, refine_every=1000,
                reset_opacities_every=1000, initial_capacity=256, log_every=1)
    losses = {True: [], False: []}
    for cached in (True, False):
        with monkeypatch.context() as m:
            _record_losses(m, ttrainer, losses[cached])
            random.seed(1)
            np.random.seed(1)
            ttrainer.train(tconfig.config_from_dict(dict(base, data_device_cache=cached)), device="cpu")
    assert len(losses[True]) == 5 and losses[True] == losses[False]
