"""Multi-device parity, image-stripe sharding: the port's ``parallel/``
(spawned gloo worlds of 2 and 4 CPU ranks) against the JAX package's
(``shard_map`` on the virtual CPU devices of ``tests/conftest.py``) on the
scene of ``tests/test_parallel.py``, numpy-seeded.

Pre-Adam gradients are held to ``tests/test_parallel.py``'s bands, each
relative to the reference's largest |g|: the oracle 1e-5; the tiled
renderer 5e-4 on uniform stripes and 5e-3 on adaptive ones (tile origins
on arbitrary rows move borderline pixels across the alpha threshold), both
against JAX's sharded gradients and against the port's single-device ones.
Integer outputs (stripe bounds, binning, counters) are equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easy_gaussian_splatting_tpu.models.gaussians import init_gaussian_state
from easy_gaussian_splatting_tpu.ops import rasterize_tiled as jrt
from easy_gaussian_splatting_tpu.parallel import shard as jshard
from easy_gaussian_splatting_tpu.parallel.mesh import make_mesh
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
from easy_gaussian_splatting_torch.parallel import shard as tshard
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from test_torch_binning import _assert_same_binning
from test_torch_binning import _scene as _screen_scene
from torch_parallel_worker import run_world

H, W = 32, 48
GRAD_RTOL = {"ref": 1e-5, "tiled": 5e-4}
ADAPT_GRAD_RTOL = {"ref": 1e-5, "tiled": 5e-3}
LOSS_RTOL = {"uniform": 1e-6, "adaptive": 5e-5}
MODES = {  # stripe layouts: partition and interleave
    "uniform": dict(stripe_partition="uniform"),
    "adaptive": dict(stripe_partition="adaptive"),
    "interleave2": dict(stripe_partition="uniform", stripe_interleave=2),
}
SIZES = (2, 4)
RENDERERS = ("ref", "tiled")


def _scene():
    """``tests/test_parallel.py``'s scene as numpy: 60 Gaussians (SH 1) in
    64 slots from the JAX package's initialiser, its camera and target."""
    rng = np.random.default_rng(0)
    xyzs = rng.uniform(-1, 1, size=(60, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(60, 3)).astype(np.uint8)
    model = init_gaussian_state(xyzs, rgbs, sh_degree=1, capacity=64)
    arrays = {n: np.array(getattr(model.params, n)) for n in tg.PARAM_NAMES}
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1.0]], np.float32)
    cam = dict(w2c=w2c, K=K, image=rng.uniform(size=(H, W, 3)).astype(np.float32),
               mask=np.zeros((H, W), np.float32))
    return arrays, np.array(model.alive), cam


ARRAYS, ALIVE, CAM = _scene()


def _cfg_kw(renderer, mode):
    return dict(renderer=renderer, raster_chunk=32, **MODES[mode])


def _jmodel():
    from easy_gaussian_splatting_tpu.models import gaussians as jg

    params = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in ARRAYS.items()})
    return jg.GaussianModelState(params=params, alive=jnp.asarray(ALIVE),
                                 stats=jg.zero_stats(ALIVE.shape[0]))


def _jcam():
    return [jnp.asarray(CAM[k]) for k in ("w2c", "K", "image", "mask")]


def _tcam():
    return [torch.as_tensor(CAM[k]) for k in ("w2c", "K", "image", "mask")]


@pytest.fixture(scope="module", params=SIZES)
def world(request):
    """Every tiles case of one world size, run once: {case: rank 0's result}."""
    n = request.param
    cases = [(("grads", r, m), "grads", dict(shape=f"tiles:{n}", cfg_kw=_cfg_kw(r, m),
                                             arrays=ARRAYS, alive=ALIVE, cam=CAM, sh_degree=1))
             for r in RENDERERS for m in MODES]
    cases += [(("count", m, red), "counter", dict(shape=f"tiles:{n}", cfg_kw=_cfg_kw("tiled", m),
                                                  arrays=ARRAYS, alive=ALIVE, cam=CAM, reduce=red))
              for m in ("uniform", "adaptive") for red in ("max", "none")]
    ranks = run_world(n, cases)
    for r in ranks[1:]:  # every rank holds the same gradients
        for case in cases:
            if case[0][0] == "grads":
                for k, v in ranks[0][case[0]]["grads"].items():
                    np.testing.assert_array_equal(r[case[0]]["grads"][k], v, err_msg=str(case[0]))
    return n, ranks[0]


def _assert_grads_match(want_g, want_a, got_g, got_a, rtol, what):
    for k in tg.PARAM_NAMES:
        x, y = np.asarray(want_g[k]), np.asarray(got_g[k])
        np.testing.assert_allclose(y, x, rtol=0, atol=rtol * max(np.abs(x).max(), 1e-8),
                                   err_msg=f"{what}: gradient of {k}")
    want_a = np.asarray(want_a)
    np.testing.assert_allclose(got_a, want_a, rtol=0, atol=rtol * max(np.abs(want_a).max(), 1e-8),
                               err_msg=f"{what}: absgrad")


# ------------------------------------------------------------ pure functions
@pytest.mark.parametrize("height,n_dev,want", [(32, 2, 1), (32, 4, 2), (32, 4, 3), (30, 4, 8),
                                               (800, 2, 4), (36, 3, 4)])
def test_effective_interleave_matches_jax(height, n_dev, want):
    assert (tshard.effective_interleave(height, n_dev, want)
            == jshard.effective_interleave(height, n_dev, want))


@pytest.mark.parametrize("n_dev,k_slabs", [(2, 1), (2, 2), (4, 2)])
def test_reorder_striped_matches_jax(n_dev, k_slabs):
    full = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    want = jshard.reorder_striped(jnp.asarray(full), n_dev, k_slabs, H, W)
    got = tshard.reorder_striped(torch.as_tensor(full), n_dev, k_slabs, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bounds", [[0, 16, 32], [0, 5, 29, 31, 32], [0, 0, 32, 32, 32]])
def test_reassemble_adaptive_matches_jax(bounds):
    n = len(bounds) - 1
    gathered = np.random.default_rng(2).uniform(size=(n * H, W, 3)).astype(np.float32)
    b = np.asarray(bounds, np.int32)
    want = jshard.reassemble_adaptive(jnp.asarray(gathered), jnp.asarray(b), n, H)
    got = tshard.reassemble_adaptive(torch.as_tensor(gathered), torch.as_tensor(b), n, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_parts", [2, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_row_bounds_matches_jax(n_parts, seed):
    """The int32 stripe bounds are equal; ``seed`` 1 moves the camera so
    that part of the population falls behind it."""
    w2c = CAM["w2c"].copy()
    if seed:
        w2c[:3, 3] = [0.3, -0.4, 0.6]
    want = jshard.adaptive_row_bounds(_jmodel().params, jnp.asarray(ALIVE), jnp.asarray(w2c),
                                      jnp.asarray(CAM["K"]), H, n_parts)
    t = tg.params_from_numpy(ARRAYS, "cpu")
    got = tshard.adaptive_row_bounds(t, torch.as_tensor(ALIVE), torch.as_tensor(w2c),
                                     torch.as_tensor(CAM["K"]), H, n_parts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0 and got[-1] == H and bool((got[1:] >= got[:-1]).all())


@pytest.mark.parametrize("y_limit", [1.0, 17.0, 23.5, 40.0])
def test_bin_gaussians_under_a_traced_y_limit_matches_jax(y_limit):
    """Binning with a 0-d ``y_limit`` is bit-equal to JAX's under the same
    traced limit; a plain number gives the port the same binning."""
    from test_torch_binning import H as BH, TS, W as BW

    m2d, con, opa, rad, dep = _screen_scene(np.random.default_rng(3), n=80, big=True)
    geom = jrt.image_geometry(BH, BW, TS)
    ext = np.array(jrt.binning_extents(jnp.asarray(con), jnp.asarray(opa), jnp.asarray(rad)))
    jb = jrt.bin_gaussians(
        jnp.asarray(m2d), jnp.asarray(ext), jnp.asarray(dep), geom, 4, 4,
        conics=jnp.asarray(con), opacities=jnp.asarray(opa), small_budget=4,
        interpret=True, y_limit=jnp.asarray(y_limit, jnp.float32),
    )
    kw = dict(conics=torch.as_tensor(con), opacities=torch.as_tensor(opa),
              small_budget=4)
    args = (torch.as_tensor(m2d), torch.as_tensor(ext), torch.as_tensor(dep),
            trt.image_geometry(BH, BW, TS), 4, 4)
    tb = trt.bin_gaussians(*args, y_limit=torch.tensor(y_limit), **kw)
    if y_limit > 1.0:
        _assert_same_binning(jb, tb)
    else:
        assert int(jb.num_isects) == int(tb.num_isects)
        np.testing.assert_array_equal(tb.tile_offsets.numpy(), np.asarray(jb.tile_offsets))
    rows = tb.tile_offsets.numpy()
    n_rows_live = -(-int(y_limit) // TS) * geom.tiles_x
    assert rows[n_rows_live] == rows[-1]  # no tile past the limit's row holds anything
    num = trt.bin_gaussians(*args, y_limit=y_limit, **kw)
    for name in ("isect_flat", "tile_offsets", "counts", "order"):
        np.testing.assert_array_equal(getattr(num, name).numpy(), getattr(tb, name).numpy())


# ------------------------------------------------------------ stripe gradients
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("renderer", RENDERERS)
def test_striped_gradients_match_jax_and_single_device(world, renderer, mode):
    """Pre-Adam gradients, absgrad, radii and loss of ``tiles:N`` against
    JAX's ``make_sharded_grad_fn`` on an N-device mesh and the port's
    single-device ``make_grad_fn``."""
    n, results = world
    got = results[("grads", renderer, mode)]
    partition = MODES[mode]["stripe_partition"]
    rtol = (ADAPT_GRAD_RTOL if partition == "adaptive" else GRAD_RTOL)[renderer]
    jcfg = jconfig.config_from_dict(_cfg_kw(renderer, mode))
    jg, ja, jld, jr = jshard.make_sharded_grad_fn(
        jcfg, make_mesh(n), jtrainer.get_render_fn(jcfg), H, W)(_jmodel(), *_jcam(), sh_degree=1)
    jg = {k: getattr(jg, k) for k in tg.PARAM_NAMES}
    _assert_grads_match(jg, ja, got["grads"], got["absgrad"], rtol, "vs JAX sharded")
    np.testing.assert_array_equal(got["radii"], np.asarray(jr))
    np.testing.assert_allclose(got["ld"]["total"], float(jld["total"]), rtol=1e-5)

    tcfg = tconfig.config_from_dict(_cfg_kw(renderer, mode))
    model = tg.GaussianModelState(params=tg.params_from_numpy(ARRAYS, "cpu"),
                                  alive=torch.as_tensor(ALIVE), stats=tg.zero_stats(64, "cpu"))
    sg, sa, sld, sr = ttrainer.make_grad_fn(tcfg, ttrainer.get_render_fn(tcfg))(
        model, *_tcam(), height=H, width=W, sh_degree=1)
    sg = {k: getattr(sg, k).numpy() for k in tg.PARAM_NAMES}
    _assert_grads_match(sg, sa.numpy(), got["grads"], got["absgrad"], rtol, "vs single device")
    np.testing.assert_array_equal(got["radii"], sr.numpy())
    np.testing.assert_allclose(got["ld"]["total"], float(sld["total"]), rtol=LOSS_RTOL[partition])
    if renderer == "tiled":
        assert got["ld"]["isects"] > 0


# ------------------------------------------------------------ isect counter
@pytest.mark.parametrize("partition", ["uniform", "adaptive"])
def test_striped_isect_counter_matches_jax(world, partition):
    """Both reduce modes equal JAX's counter as integers; the maximum is
    the intersection count the sharded tiled step reports."""
    n, results = world
    mesh = make_mesh(n)
    jkw = dict(ov_frac=0.125, partition=partition)
    cfg = jconfig.config_from_dict(_cfg_kw("tiled", partition))
    args = (_jmodel().params, jnp.asarray(ALIVE), jnp.asarray(CAM["w2c"]), jnp.asarray(CAM["K"]))
    for reduce in ("max", "none"):
        want = np.asarray(jshard.make_striped_isect_counter(
            mesh, cfg.tile_size, cfg.max_tiles, cfg.max_tiles, reduce=reduce, **jkw)(
            *args, height=H, width=W))
        got = results[("count", partition, reduce)]
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    per_rank = results[("count", partition, "none")]
    assert per_rank.shape[0] == n
    n_max = int(results[("count", partition, "max")][0])
    assert n_max == int(results[("grads", "tiled", partition)]["ld"]["isects"]) > 0
    assert int(per_rank[:, 0].max()) == n_max
