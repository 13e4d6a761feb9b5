"""Model-level parity: the port renders the JAX package's weights (carried
over as numpy arrays, or through a checkpoint written by either package)
like the JAX package does; compaction and the inference autotune agree."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easy_gaussian_splatting_tpu.models import gaussians as jg
from easy_gaussian_splatting_tpu.models.render import CameraView as JCameraView
from easy_gaussian_splatting_tpu.ops.rasterize_tiled import make_tiled_render_fn as j_tiled_fn
from easy_gaussian_splatting_tpu.training.config import config_from_dict as j_config
from easy_gaussian_splatting_tpu.training.trainer import tune_inference_cfg as j_tune
from easy_gaussian_splatting_tpu.utils import checkpoint as jckpt
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.models.render import CameraView, render
from easy_gaussian_splatting_torch.ops.rasterize_tiled import make_tiled_render_fn
from easy_gaussian_splatting_torch.training.config import config_from_dict
from easy_gaussian_splatting_torch.training.trainer import tune_inference_cfg
from easy_gaussian_splatting_torch.utils import checkpoint as tckpt

H, W = 40, 72
TS = 16
BG = np.array([1.0, 1.0, 1.0], np.float32)


def _arrays(rng, n=100, capacity=128):
    """SH-degree-3 parameters with view-dependent colour, in capacity
    buffers with some dead slots."""
    means = rng.uniform(-1.0, 1.0, size=(capacity, 3)).astype(np.float32)
    log_scales = rng.uniform(-3.5, -2.0, size=(capacity, 3)).astype(np.float32)
    quats = rng.normal(size=(capacity, 4)).astype(np.float32)
    sh_0 = rng.normal(0.0, 0.8, size=(capacity, 1, 3)).astype(np.float32)
    sh_rest = rng.normal(0.0, 0.2, size=(capacity, 15, 3)).astype(np.float32)
    logit = rng.normal(0.0, 1.5, size=(capacity,)).astype(np.float32)
    alive = np.zeros(capacity, bool)
    alive[rng.permutation(capacity)[:n]] = True
    return dict(means=means, log_scales=log_scales, quats=quats, sh_0=sh_0,
                sh_rest=sh_rest, logit_opacities=logit), alive


def _camera(yaw=0.3):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    w2c[:3, 3] = [0.1, -0.05, 4.0]
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    return w2c, K


def _jax_state(arrays, alive):
    params = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jg.GaussianModelState(
        params=params, alive=jnp.asarray(alive), stats=jg.zero_stats(alive.shape[0])
    )


def _torch_state(arrays, alive):
    return tg.GaussianModelState(
        params=tg.params_from_numpy(arrays, "cpu"),
        alive=torch.as_tensor(alive),
        stats=tg.zero_stats(alive.shape[0], "cpu"),
    )


def _render_jax(state, w2c, K, sh_degree=3):
    rf = j_tiled_fn(tile_size=TS, isect_mult=8, interpret=True)
    out = rf(
        state.params, state.alive,
        JCameraView(w2c=jnp.asarray(w2c), K=jnp.asarray(K), width=W, height=H),
        sh_degree, jnp.asarray(BG), jnp.zeros((state.capacity, 2)),
    )
    return np.asarray(out.image), int(out.num_isects)


def _render_torch(state, w2c, K, sh_degree=3):
    rf = make_tiled_render_fn(tile_size=TS, isect_mult=8)
    out = rf(
        state.params, state.alive,
        CameraView(w2c=torch.as_tensor(w2c), K=torch.as_tensor(K), width=W, height=H),
        sh_degree, torch.as_tensor(BG),
    )
    return out.image.numpy(), int(out.num_isects)


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_render_from_carried_weights(rng, sh_degree):
    """The same numpy weights through both packages' tiled render: the
    projection and SH agree to a few ulps, binning exactly, so the image
    agrees to 1e-4 (the bound of the high-opacity rasterizer test)."""
    arrays, alive = _arrays(rng)
    w2c, K = _camera()
    j_img, j_n = _render_jax(_jax_state(arrays, alive), w2c, K, sh_degree)
    t_img, t_n = _render_torch(_torch_state(arrays, alive), w2c, K, sh_degree)
    assert t_n == j_n > 0
    np.testing.assert_allclose(t_img, j_img, atol=1e-4)
    assert np.abs(t_img - BG).max() > 0.2  # the scene is visible


def test_params_numpy_roundtrip(rng):
    arrays, _ = _arrays(rng)
    back = tg.params_to_numpy(tg.params_from_numpy(arrays, "cpu"))
    for k in tg.PARAM_NAMES:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert tg.PARAM_NAMES == jg.PARAM_NAMES


def test_jax_checkpoint_loads_and_renders(rng, tmp_path):
    arrays, alive = _arrays(rng)
    jstate = _jax_state(arrays, alive)
    path = tmp_path / "checkpoints" / "iterations_700.npz"
    jckpt.save_checkpoint(path, jstate, 3, 700)
    assert tckpt.find_checkpoint(tmp_path) == path
    tstate, sh, step, adam = tckpt.load_checkpoint(path, device="cpu")
    assert adam is None
    assert (sh, step) == (3, 700)
    np.testing.assert_array_equal(tstate.alive.numpy(), alive)
    w2c, K = _camera(0.7)
    j_img, _ = _render_jax(jstate, w2c, K)
    t_img, _ = _render_torch(tstate, w2c, K)
    np.testing.assert_allclose(t_img, j_img, atol=1e-4)


def test_torch_checkpoint_loads_in_jax(rng, tmp_path):
    arrays, alive = _arrays(rng)
    path = tmp_path / "checkpoints" / "iterations_5.npz"
    tckpt.save_checkpoint(path, _torch_state(arrays, alive), 2, 5)
    jstate, sh, step, adam = jckpt.load_checkpoint(path)
    assert (sh, step, adam) == (2, 5, None)
    for k in tg.PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jstate.params, k)), arrays[k])
    np.testing.assert_array_equal(np.asarray(jstate.alive), alive)


def test_checkpoint_with_optimizer_state_loads(rng, tmp_path):
    """A JAX checkpoint that carries Adam moments loads with them."""
    from easy_gaussian_splatting_tpu.models.optimizer import init_adam_state

    arrays, alive = _arrays(rng)
    jstate = _jax_state(arrays, alive)
    path = tmp_path / "iterations_9.npz"
    jckpt.save_checkpoint(path, jstate, 3, 9, adam=init_adam_state(jstate.params))
    tstate, _, _, adam = tckpt.load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(tstate.params.means.numpy(), arrays["means"])
    assert adam is not None and int(adam.steps["means"]) == 0
    np.testing.assert_array_equal(adam.mu.sh_rest.numpy(), np.zeros_like(arrays["sh_rest"]))


def test_compact_for_inference_keeps_alive_set(rng):
    arrays, alive = _arrays(rng, n=700, capacity=1536)
    jc = jg.compact_for_inference(_jax_state(arrays, alive))
    tc = tg.compact_for_inference(_torch_state(arrays, alive))
    assert tc.capacity == jc.capacity == 1024
    np.testing.assert_array_equal(tc.alive.numpy(), np.asarray(jc.alive))
    for k in tg.PARAM_NAMES:
        np.testing.assert_array_equal(
            getattr(tc.params, k).numpy(), np.asarray(getattr(jc.params, k))
        )
    assert tg._round_up_capacity(1300) == jg._round_up_capacity(1300) == 1536


def test_init_gaussian_state_matches_jax(rng):
    xyz = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(300, 3)).astype(np.uint8)
    js = jg.init_gaussian_state(xyz, rgb, 3)
    ts = tg.init_gaussian_state(xyz, rgb, 3, device="cpu")
    assert ts.capacity == js.capacity
    for k in tg.PARAM_NAMES:
        np.testing.assert_allclose(
            getattr(ts.params, k).numpy(), np.asarray(getattr(js.params, k)),
            rtol=1e-6, atol=1e-7,
        )
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_tune_inference_cfg_matches_jax(rng):
    arrays, alive = _arrays(rng, n=900, capacity=1024)
    w2c, K = _camera()
    jcfg = j_tune(j_config(dict(tile_size=TS)), _jax_state(arrays, alive), w2c, K, H, W)
    tcfg = tune_inference_cfg(config_from_dict(dict(tile_size=TS)), _torch_state(arrays, alive), w2c, K, H, W)
    assert (tcfg.isect_mult, tcfg.small_budget, tcfg.ov_frac) == (
        jcfg.isect_mult, jcfg.small_budget, jcfg.ov_frac
    )
    assert tcfg.isect_mult != 3.0  # the probe moved it off the default
