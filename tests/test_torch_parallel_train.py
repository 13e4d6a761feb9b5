"""Multi-device parity, ``train(cfg)`` under ``mesh_shape``: three steps
of the port's loop on spawned gloo ranks (``tiles:2`` and ``gauss:2`` on 2,
``gauss:2,tiles:2`` on 4) against the JAX package's ``train()`` on the same
mesh of its virtual CPU devices, from one generated Blender scene, with an
eval at step 1 (rank 0, the other ranks waiting), a densify event at step
3, a checkpoint at step 4 and the training viewer on rank 0. The three steps before the event agree within
1e-4 relative, as ``test_train_loop_matches_jax`` holds the single-device
loops (the event's split noise comes from each package's own generator)."""

import random

import numpy as np
import pytest

from easy_gaussian_splatting_tpu.parallel import gauss_shard as jgs
from easy_gaussian_splatting_tpu.parallel import shard as jshard
from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.training import trainer as jtrainer
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.utils.checkpoint import load_checkpoint
from test_torch_training import CFG, _generated_scene
from torch_parallel_worker import run_world

SHAPES = {"tiles:2": 2, "gauss:2": 2, "gauss:2,tiles:2": 4}
STEPS = 4
EVENT = 3  # the densify event: the losses before it are compared


def _sched(scene_kw, shape, output):
    return dict(CFG, **scene_kw, mesh_shape=shape, total_iterations=STEPS, eval=True,
                eval_every=1000, eval_render_num=1, refine_start=0, refine_every=EVENT,
                reset_opacities_every=1000, initial_capacity=256, log_every=1,
                data_device_cache=True, output=output, save_model_iterations=[STEPS])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, and every shape's port run: {shape: every rank's result}."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    scene_kw = _generated_scene(tmp, "blender")
    out = {}
    for n in sorted(set(SHAPES.values())):
        # the port's runs serve the training viewer too (on rank 0, from a
        # gathered copy under gauss), which changes no loss
        cases = [(shape, "train_losses",
                  dict(cfg_kw=dict(_sched(scene_kw, shape, str(tmp / shape)), view_online=True),
                       seed=0))
                 for shape, size in SHAPES.items() if size == n]
        ranks = run_world(n, cases)
        for shape, *_ in cases:
            out[shape] = [r[shape] for r in ranks]
    return tmp, scene_kw, out


def _jax_losses(monkeypatch, sched):
    losses = []
    for mod, name in ((jshard, "make_sharded_train_step"),
                      (jgs, "make_gauss_sharded_train_step")):
        def make(*a, _orig=getattr(mod, name), **k):
            step = _orig(*a, **k)

            def run(*a, **k):
                res = step(*a, **k)
                losses.append(float(res[2]["total"]))
                return res

            return run

        monkeypatch.setattr(mod, name, make)
    random.seed(0)
    np.random.seed(0)
    loop = jtrainer.train(jconfig.config_from_dict(sched))
    return losses, loop


@pytest.mark.parametrize("shape", list(SHAPES))
def test_train_under_a_mesh_matches_jax(runs, monkeypatch, shape):
    tmp, scene_kw, out = runs
    ranks = out[shape]
    # the JAX run without its eval's renders or an output: neither draws from
    # the generators
    from easy_gaussian_splatting_tpu.evaluation.evaluator import Evaluator

    monkeypatch.setattr(Evaluator, "evaluate", lambda self, *a, **k: {})
    jlosses, jloop = _jax_losses(monkeypatch, _sched(scene_kw, shape, None))
    got = ranks[0]
    assert got["step"] == jloop.step == STEPS
    assert len(got["losses"]) == len(jlosses) == STEPS
    np.testing.assert_allclose(got["losses"][:EVENT], jlosses[:EVENT], rtol=1e-4)
    assert np.isfinite(got["losses"]).all()
    for r in ranks[1:]:  # every rank logged the same losses and ends with the same state
        assert r["losses"] == got["losses"]
        for k, v in got["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    cap = got["state"]["alive"].shape[0]
    assert cap == jloop.model.capacity and cap % 2 == 0
    # rank 0 alone wrote the run's files: the checkpoint holds the whole model
    model, _, step, _ = load_checkpoint(tmp / shape / "checkpoints" / f"iterations_{STEPS}.npz",
                                           device="cpu")
    assert step == STEPS and model.capacity == cap
    np.testing.assert_array_equal(model.params.means.numpy(), got["state"]["means"])
    np.testing.assert_array_equal(model.alive.numpy(), got["state"]["alive"])
    assert (tmp / shape / "cameras.json").exists()
    assert [r["viewers"] for r in ranks] == [1] + [0] * (len(ranks) - 1)
    assert int(got["state"]["alive"].sum()) > 0
    assert set(got["state"]) >= {f"mu.{k}" for k in tg.PARAM_NAMES}
