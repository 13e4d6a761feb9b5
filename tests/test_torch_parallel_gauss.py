"""Multi-device parity, Gaussian sharding and the sharded steps: the port's
``parallel/`` (spawned gloo worlds of CPU ranks) against the JAX package's
on its virtual CPU devices, on ``tests/test_torch_parallel.py``'s scene.

- ``gauss:2`` and ``gauss:2,tiles:2`` pre-Adam gradients against JAX's
  ``make_gauss_sharded_grad_fn``, in ``tests/test_parallel.py``'s bands;
- the sharded densify step fed JAX's per-shard ``fold_in`` noise, and
  ``grow_state_sharded``, against JAX's, exactly;
- ``maybe_initialize_from_env`` joining two processes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from easy_gaussian_splatting_tpu.models import density as jd
from easy_gaussian_splatting_tpu.models import gaussians as jg
from easy_gaussian_splatting_tpu.models import optimizer as jo
from easy_gaussian_splatting_tpu.parallel import gauss_shard as jgs
from easy_gaussian_splatting_tpu.parallel.mesh import make_mesh, make_mesh2d
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.parallel import distributed
from test_torch_parallel import (
    ADAPT_GRAD_RTOL,
    ALIVE,
    ARRAYS,
    CAM,
    GRAD_RTOL,
    H,
    LOSS_RTOL,
    W,
    _assert_grads_match,
    _jcam,
    _jmodel,
)
from torch_parallel_worker import run_world

NAMES = tg.PARAM_NAMES
GAUSS_SHAPES = {2: "gauss:2", 4: "gauss:2,tiles:2"}
DCFG = dict(densify_grad_thresh=1.0, densify_scale_thresh=0.5, num_splits=2,
            prune_radii_ratio_thresh=10.0, prune_scale_thresh=100.0, min_opacity=0.005)
SEED_KEY = 3


def _cfg_kw(renderer, partition):
    return dict(renderer=renderer, raster_chunk=32, stripe_partition=partition)


def _jmesh(shape):
    sizes = dict(p.split(":") for p in shape.split(","))
    if len(sizes) == 2:
        return make_mesh2d(int(sizes["gauss"]), int(sizes["tiles"]))
    ((axis, n),) = sizes.items()
    return make_mesh(int(n), axis=axis)


def _densify_arrays():
    """``tests/test_parallel.py``'s densify state: rows 32-33 clone, 34-35
    split, 36-37 are pruned, in a shard with free slots; random Adam."""
    arrays = {k: v.copy() for k, v in ARRAYS.items()}
    arrays["log_scales"][34:36] = 1.0
    arrays["logit_opacities"][36:38] = -12.0
    alive = np.arange(64) < 40
    accum = np.zeros(64, np.float32)
    accum[32:36] = 100.0
    stats = dict(grad_norm_accum=accum, collecting_counts=np.ones(64, np.float32),
                 max_radii=np.zeros(64, np.float32))
    rng = np.random.default_rng(5)
    mu = {k: rng.normal(0, 1e-3, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    nu = {k: rng.uniform(0, 1e-5, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    return arrays, alive, stats, (mu, nu, {k: 3 for k in NAMES})


def _jstate(arrays, alive, stats, adam):
    params = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    st = jg.DensifyStats(**{k: jnp.asarray(v) for k, v in stats.items()})
    mu, nu, steps = adam
    ja = jo.AdamState(mu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
                      nu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
                      steps={k: jnp.asarray(v, jnp.int32) for k, v in steps.items()})
    return jg.GaussianModelState(params=params, alive=jnp.asarray(alive), stats=st), ja


def _shard_noise(n_shards):
    key = jax.random.PRNGKey(SEED_KEY)
    return [np.array(jax.random.normal(jax.random.fold_in(key, g), (64 // n_shards, 3),
                                       jnp.float32)) for g in range(n_shards)]


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    """Every gauss-sharded case of one world size (``gauss:2`` on 2 ranks,
    ``gauss:2,tiles:2`` on 4), run once: (n, rank 0's results)."""
    n = request.param
    cases = [(("grads", r, p), "grads", dict(shape=GAUSS_SHAPES[n], cfg_kw=_cfg_kw(r, p),
                                             arrays=ARRAYS, alive=ALIVE, cam=CAM, sh_degree=1))
             for r in ("ref", "tiled") for p in ("uniform", "adaptive")]
    d_arrays, d_alive, d_stats, d_adam = _densify_arrays()
    cases += [
        ("densify", "densify", dict(shape=GAUSS_SHAPES[n], dcfg_kw=DCFG, arrays=d_arrays,
                                    alive=d_alive, stats=d_stats, adam=d_adam,
                                    noise=_shard_noise(2))),
        ("grow", "grow", dict(shape=GAUSS_SHAPES[n], arrays=d_arrays, alive=d_alive,
                              stats=d_stats, adam=d_adam, new_capacity=128)),
    ]
    return n, run_world(n, cases)[0]


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("partition", ["uniform", "adaptive"])
@pytest.mark.parametrize("renderer", ["ref", "tiled"])
def test_gauss_sharded_gradients_match_jax(world, renderer, partition):
    """``gauss:2`` (world of 2) and ``gauss:2,tiles:2`` (world of 4):
    gathered gradients, absgrad, radii and loss against JAX's on the same
    mesh. JAX reduce-scatters n identical cotangents and divides by n; the
    port sums each rank's own stripe's gradient: the same sum."""
    n, results = world
    got = results[("grads", renderer, partition)]
    jcfg = jconfig.config_from_dict(_cfg_kw(renderer, partition))
    mesh = _jmesh(GAUSS_SHAPES[n])
    jgr, ja, jld, jr = jgs.make_gauss_sharded_grad_fn(
        jcfg, mesh, jtrainer.get_render_fn(jcfg), H, W)(
        jgs.shard_state(_jmodel(), mesh), *_jcam(), sh_degree=1)
    rtol = (ADAPT_GRAD_RTOL if partition == "adaptive" else GRAD_RTOL)[renderer]
    _assert_grads_match({k: getattr(jgr, k) for k in NAMES}, ja, got["grads"], got["absgrad"],
                        rtol, GAUSS_SHAPES[n])
    np.testing.assert_array_equal(got["radii"], np.asarray(jr))
    np.testing.assert_allclose(got["ld"]["total"], float(jld["total"]),
                               rtol=max(1e-5, LOSS_RTOL[partition]))


# ------------------------------------------------------------ densify, growth
def test_sharded_densify_matches_jax(world):
    """Fed JAX's per-shard ``fold_in(key, g)`` split noise, the sharded event
    equals JAX's: alive set, parameters, moments, info and overflow."""
    n, results = world
    got = results["densify"]
    arrays, alive, stats, adam = _densify_arrays()
    mesh = _jmesh(GAUSS_SHAPES[n])
    js, ja = _jstate(arrays, alive, stats, adam)
    js2, ja2, jinfo, jover = jgs.make_sharded_densify_step(jd.DensifyConfig(**DCFG), mesh)(
        jgs.shard_state(js, mesh), jgs.shard_state(ja, mesh), jax.random.PRNGKey(SEED_KEY))
    assert got["overflow"] == bool(jover) is False
    assert got["info"] == {k: int(v) for k, v in jinfo.items()}
    assert got["info"]["split"] == 2 and got["info"]["clone"] == 2
    st = got["state"]
    np.testing.assert_array_equal(st["alive"], np.asarray(js2.alive))
    for k in NAMES:
        np.testing.assert_allclose(st[k], np.asarray(getattr(js2.params, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(st[f"mu.{k}"], np.asarray(getattr(ja2.mu, k)), err_msg=k)
        np.testing.assert_array_equal(st[f"nu.{k}"], np.asarray(getattr(ja2.nu, k)), err_msg=k)
    np.testing.assert_array_equal(st["stats.grad_norm_accum"], 0.0)


def test_grow_state_sharded_matches_jax(world):
    """Per-shard padding: each 32-row shard grows to 64 rows, the new slots
    dead, zero, identity quats and zero moments, equal to JAX's."""
    n, results = world
    st = results["grow"]
    arrays, alive, stats, adam = _densify_arrays()
    mesh = _jmesh(GAUSS_SHAPES[n])
    js, ja = _jstate(arrays, alive, stats, adam)
    jm, jad = jgs.grow_state_sharded(jgs.shard_state(js, mesh), jgs.shard_state(ja, mesh), 128,
                                     mesh)
    assert st["alive"].shape == (128,) == np.asarray(jm.alive).shape
    np.testing.assert_array_equal(st["alive"], np.asarray(jm.alive))
    np.testing.assert_array_equal(st["alive"].reshape(2, 64)[:, :32], alive.reshape(2, 32))
    for k in NAMES:
        np.testing.assert_array_equal(st[k], np.asarray(getattr(jm.params, k)), err_msg=k)
        np.testing.assert_array_equal(st[f"mu.{k}"], np.asarray(getattr(jad.mu, k)), err_msg=k)
    for k in ("grad_norm_accum", "collecting_counts", "max_radii"):
        np.testing.assert_array_equal(st[f"stats.{k}"], np.asarray(getattr(jm.stats, k)))


# ------------------------------------------------------------ joining
def test_maybe_initialize_from_env_joins_two_processes(monkeypatch):
    """Two processes join one gloo world through ``EGS_TORCH_COORDINATOR``,
    ``EGS_TORCH_NUM_PROCESSES`` and ``EGS_TORCH_PROCESS_ID``; without them
    (or ``EGS_TORCH_DISTRIBUTED=1``) nothing is joined."""
    ranks = run_world(2, [("sum", "join_sum", dict(value=10))], env_join=True)
    for r, res in enumerate(ranks):
        assert res["sum"] == {"sum": 21.0, "world": 2, "rank": r, "backend": "gloo"}
    for var in ("EGS_TORCH_COORDINATOR", "EGS_TORCH_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize_from_env(device="cpu") is False
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda") == "nccl"


def test_densify_noise_is_per_shard():
    """Each shard's split noise comes from a seed of its own: one event's
    shard seeds differ, and fit a generator's 63 bits."""
    from easy_gaussian_splatting_torch.parallel.gauss_shard import shard_seed

    seeds = [shard_seed(12345, g) for g in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2**63 for s in seeds)
