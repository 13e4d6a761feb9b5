"""Multi-device parity, the sharded train steps: one step of each kind
(``tiles:2``, ``gauss:2`` on 2 spawned gloo ranks, ``gauss:2,tiles:2`` on
4) against the JAX package's on the same mesh of its virtual CPU devices,
with both renderers, on ``tests/test_torch_parallel.py``'s scene."""

import numpy as np
import pytest

from easy_gaussian_splatting_tpu.models import optimizer as jo
from easy_gaussian_splatting_tpu.parallel import gauss_shard as jgs
from easy_gaussian_splatting_tpu.parallel import shard as jshard
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.models import gaussians as tg
from test_torch_parallel import ALIVE, ARRAYS, CAM, H, W, _jcam, _jmodel
from test_torch_parallel_gauss import _cfg_kw, _jmesh
from torch_parallel_worker import run_world

NAMES = tg.PARAM_NAMES
STEP_SHAPES = {"tiles:2": 2, "gauss:2": 2, "gauss:2,tiles:2": 4}
LR_MEANS = 1e-2


@pytest.fixture(scope="module")
def worlds():
    """Every step case, one world a size, run once: {size: every rank's results}."""
    out = {}
    for n in sorted(set(STEP_SHAPES.values())):
        cases = [((shape, r), "train_step",
                  dict(shape=shape, cfg_kw=_cfg_kw(r, "uniform"), arrays=ARRAYS, alive=ALIVE,
                       cam=CAM, sh_degree=1, lr_means=LR_MEANS))
                 for shape, size in STEP_SHAPES.items() if size == n for r in ("ref", "tiled")]
        out[n] = run_world(n, cases)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("renderer", ["ref", "tiled"])
@pytest.mark.parametrize("shape", list(STEP_SHAPES))
def test_sharded_train_step_matches_jax(worlds, shape, renderer):
    """One sharded step (stats on, no event) from a fresh Adam state: the
    loss, the statistics, Adam's step counts and moments, and the
    parameters where the gradient clears 1e-3 of its group's largest (on
    the first step Adam moves a parameter by ~lr * sign(g), so where g is
    rounding noise the packages may move it by up to 2 * lr apart). Under
    ``tiles`` every rank ends bit for bit equal."""
    ranks = worlds[STEP_SHAPES[shape]]
    got = ranks[0][(shape, renderer)]
    st = got["state"]
    jcfg = jconfig.config_from_dict(_cfg_kw(renderer, "uniform"))
    mesh = _jmesh(shape)
    rf = jtrainer.get_render_fn(jcfg)
    model, adam = _jmodel(), jo.init_adam_state(_jmodel().params)
    flags = (np.float32(LR_MEANS), np.bool_(True), np.bool_(False), np.bool_(False))
    if shape.startswith("gauss"):
        jm, jad, jld = jgs.make_gauss_sharded_train_step(jcfg, mesh, rf, H, W)(
            jgs.shard_state(model, mesh), jgs.shard_state(adam, mesh), *_jcam(), *flags,
            sh_degree=1)
    else:
        jm, jad, jld = jshard.make_sharded_train_step(jcfg, mesh, rf, H, W)(
            model, adam, *_jcam(), *flags, sh_degree=1)
    np.testing.assert_allclose(got["ld"]["total"], float(jld["total"]), rtol=1e-5)
    np.testing.assert_array_equal(st["stats.collecting_counts"],
                                  np.asarray(jm.stats.collecting_counts))
    np.testing.assert_allclose(st["stats.max_radii"], np.asarray(jm.stats.max_radii), rtol=2e-7)
    tol = 1e-3 if renderer == "tiled" else 1e-5
    assert _rel_l2(st["stats.grad_norm_accum"], np.asarray(jm.stats.grad_norm_accum)) < tol
    lrs = dict(means=LR_MEANS, log_scales=jcfg.log_scales_lr, quats=jcfg.quats_lr,
               sh_0=jcfg.sh_0_lr, sh_rest=jcfg.sh_rest_lr, logit_opacities=jcfg.logit_opacities_lr)
    for k in NAMES:
        assert st[f"steps.{k}"] == int(jad.steps[k]) == 1
        jmu = np.asarray(getattr(jad.mu, k))
        assert _rel_l2(st[f"mu.{k}"], jmu) < tol, k
        g = np.abs(st[f"mu.{k}"])
        clear = g > 1e-3 * g.max()
        np.testing.assert_allclose(st[k][clear], np.asarray(getattr(jm.params, k))[clear], rtol=0,
                                   atol=1e-6 + 1e-3 * lrs[k], err_msg=k)
    if renderer == "tiled":
        assert got["ld"]["isects"] > 0
    if shape.startswith("tiles"):
        for r in ranks[1:]:
            for k, v in st.items():
                np.testing.assert_array_equal(r[(shape, renderer)]["state"][k], v, err_msg=k)
