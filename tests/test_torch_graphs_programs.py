"""The programs ``training/graphs.py`` compiles besides the single step: the
sharded steps (``parallel/shard.py``, ``parallel/gauss_shard.py``), the
batched step and the evaluator's frame and LPIPS programs.

On the CPU: each step's capture contract (the flags and learning rate as
0-d tensors and ``in_place`` give the bits of host flags returning new
tensors; the sharded steps in a gloo world of 2 through
``tests/torch_parallel_worker.py``), ``train()`` under gloo running the
eager step and logging why, and the evaluator's metrics equal to the plain
per-frame computation. On the card (``cuda`` marker; skipped elsewhere):
the graphed batched step, the graphed eval and an NCCL world of one rank
against their eager versions, bit for bit.

Nothing here imports JAX, so on the card the file runs without the suite's
conftest:

    python -m pytest tests/test_torch_graphs_programs.py -m cuda --noconftest -q
"""

import logging
import random

import numpy as np
import pytest
import torch
from test_torch_graphs import (
    CFG,
    FLAGS,
    NAMES,
    H,
    W,
    assert_bitwise,
    leaves,
    scene_arrays,
    torch_state,
)
from torch_parallel_worker import run_world

from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict

B = 2  # views of the batched step on the CPU


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _adam_np(arrays, rng):
    """Adam moments three steps in, as numpy (the worker's format)."""
    mu = {k: rng.normal(0, 1e-3, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    nu = {k: rng.uniform(0, 1e-5, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    return mu, nu, {k: 3 for k in NAMES}


# ------------------------------------------------------- the sharded steps
@pytest.fixture(scope="module")
def gloo_world():
    """One gloo world of 2 CPU ranks: the tiles and gauss sharded steps under
    each flag combination three ways, and two ``train()`` steps under
    ``tiles:2``."""
    rng = np.random.default_rng(0)
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    stats = {k: np.random.default_rng(i).uniform(0, 2, size=alive.shape[0]).astype(np.float32)
             for i, k in enumerate(("grad_norm_accum", "collecting_counts", "max_radii"))}
    cam = dict(w2c=w2c, K=K, image=image, mask=mask)
    cfg_kw = dict(CFG, stripe_partition="uniform")
    common = dict(arrays=arrays, alive=alive, stats=stats, adam=_adam_np(arrays, rng), cam=cam,
                  sh_degree=3, lr_means=1e-3, flags=FLAGS, cfg_kw=cfg_kw)
    xyzs = rng.uniform(-0.6, 0.6, size=(60, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(60, 3)).astype(np.uint8)
    frame = dict(K=K, height=H, width=W, w2c=w2c, image=image, mask=mask)
    cases = [("tiles:2", "flag_steps", dict(common, shape="tiles:2")),
             ("gauss:2", "flag_steps", dict(common, shape="gauss:2")),
             ("train", "train_eager_log", dict(shape="tiles:2", seed=0, frame=frame,
                                               arrays=dict(xyzs=xyzs, rgbs=rgbs)))]
    return run_world(2, cases)


@pytest.mark.parametrize("shape", ["tiles:2", "gauss:2"])
def test_sharded_step_tensor_flags_and_in_place_equal_host_flags(gloo_world, shape):
    """The sharded step's capture contract, in a gloo world of 2: with the
    learning rate and flags as 0-d tensors, and with ``in_place`` (which
    returns the tensors it was given), every flag combination gives the
    bits of the step with host values, on both ranks alike."""
    for fl, runs0, runs1 in zip(FLAGS, gloo_world[0][shape], gloo_world[1][shape]):
        want = runs0["host"]
        for runs in (runs0, runs1):
            for mode in ("host", "tensor", "in_place"):
                got = runs[mode]
                assert got["state"].keys() == want["state"].keys()
                for k, v in want["state"].items():
                    np.testing.assert_array_equal(got["state"][k], v, err_msg=f"{fl} {mode} {k}")
                for k, v in want["ld"].items():
                    np.testing.assert_array_equal(got["ld"][k], v, err_msg=f"{fl} {mode} {k}")
            assert runs["in_place"]["same_tensors"] and not runs["host"]["same_tensors"], fl
        steps = want["state"]
        skip_all, skip_opac = fl[1], fl[2]
        for k in NAMES:
            skipped = skip_all or (skip_opac and k == "logit_opacities")
            assert steps[f"steps.{k}"] == (3 if skipped else 4), (fl, k)


def test_train_under_gloo_runs_the_eager_step_and_logs_why(gloo_world):
    """``train()`` on a gloo mesh builds no graphed step (gloo's collectives
    cannot be captured) and says so once, at its start, on rank 0."""
    r0, r1 = gloo_world[0]["train"], gloo_world[1]["train"]
    assert r0["step"] == r1["step"] == 2 and r0["built"] == r1["built"] == 0
    why = [line for line in r0["lines"] if line.startswith("the train step runs eagerly: ")]
    assert len(why) == 1, r0["lines"]
    assert "gloo collectives wait on the host" in why[0] and "cpu is not a CUDA device" in why[0]
    assert not r1["lines"]  # rank 0 alone logs


def test_train_on_the_cpu_logs_why_it_runs_eagerly(rng, caplog):
    from test_torch_graphs import _train_tiny

    with caplog.at_level(logging.INFO, logger="easy_gaussian_splatting_torch"):
        loop = _train_tiny(rng, total_iterations=1, renderer="ref")
    assert loop.step == 1
    why = [r.getMessage() for r in caplog.records
           if r.getMessage().startswith("the train step runs eagerly: ")]
    assert why == ["the train step runs eagerly: cpu is not a CUDA device (a CUDA graph runs "
                   "on one only)"]


# -------------------------------------------------------- the batched step
def _batched_frames(w2c, K, rng, b=B, h=H, w=W, device="cpu"):
    w2cs = np.stack([w2c] * b)
    w2cs[:, 0, 3] += 0.1 * np.arange(b)
    images = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    return [torch.as_tensor(x, device=device)
            for x in (w2cs, np.stack([K] * b), images, np.zeros((b, h, w), np.float32))]


@pytest.mark.parametrize("flags", FLAGS)
def test_batched_step_tensor_flags_and_in_place_equal_host_flags(rng, flags):
    """The batched step's capture contract: 0-d tensor flags and
    ``in_place`` give the bits of host flags returning new tensors, and
    the in-place step returns the tensors it was given."""
    arrays, alive, w2c, K, _, _ = scene_arrays(rng)
    frames = _batched_frames(w2c, K, rng)
    cfg = config_from_dict(CFG)
    step = ttrainer.make_batched_train_step(cfg, ttrainer.get_render_fn(cfg))
    kw = dict(height=H, width=W, sh_degree=3)
    want = step(*torch_state(arrays, alive, "cpu", np.random.default_rng(1)), *frames,
                1e-3, *flags, **kw)
    tensors = [torch.tensor(1e-3)] + [torch.tensor(f) for f in flags]
    got = step(*torch_state(arrays, alive, "cpu", np.random.default_rng(1)), *frames,
               *tensors, **kw)
    assert_bitwise(leaves(*got), leaves(*want))
    model, adam = torch_state(arrays, alive, "cpu", np.random.default_rng(1))
    given = leaves(model, adam)
    got = step(model, adam, *frames, *tensors, **kw, in_place=True)
    assert_bitwise(leaves(*got), leaves(*want))
    for k, t in leaves(got[0], got[1]).items():
        assert t is given[k], k


# ----------------------------------------------------------- the evaluator
class _Frames:
    """An eval split of ``n`` frames of one size around the scene."""

    def __init__(self, rng, n=3):
        _, _, w2c, K, _, _ = scene_arrays(rng)
        self.frames = []
        for i in range(n):
            w2c_i = w2c.copy()
            w2c_i[0, 3] += 0.1 * i
            mask = np.zeros((H, W), np.float32)
            mask[:4] = 1.0
            self.frames.append(dict(w2c=w2c_i, K=K, height=H, width=W, mask=mask,
                                    image=rng.uniform(size=(H, W, 3)).astype(np.float32)))

    def nbr_data(self, split):
        return len(self.frames) if split == "eval" else 0

    def get_data(self, split, index):
        return dict(self.frames[index])


def _plain_eval(ev, model, scene, bg):
    """The metrics as the evaluator computed them before its programs: each
    frame rendered, composited, scored, the sums over frames divided by n."""
    from easy_gaussian_splatting_torch.models.loss import composite_mask
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.evaluation.metrics import psnr, ssim

    psnrs, ssims, lp = [], [], []
    for i in range(scene.nbr_data("eval")):
        d = {k: torch.as_tensor(v, dtype=torch.float32) if isinstance(v, np.ndarray) else v
             for k, v in scene.get_data("eval", i).items()}
        cam = CameraView(w2c=d["w2c"], K=d["K"], width=W, height=H)
        img = ev.render_fn(model.params, model.alive, cam, 3, bg, None).image
        comp = composite_mask(img, d["image"], d["mask"])
        psnrs.append(psnr(comp, d["image"]))
        ssims.append(ssim(d["image"], comp))
        lp.append(ev.lpips.device_fn(comp, d["image"]))
    n = len(psnrs)
    vals = torch.stack(psnrs + ssims).numpy()
    return dict(psnr=float(vals[:n].sum()) / n, ssim=float(vals[n:].sum()) / n,
                lpips_proxy=float(torch.stack(lp).sum()) / n)


def test_evaluator_metrics_on_the_cpu_are_the_plain_ones(rng):
    """On the CPU the evaluator runs eagerly, and its PSNR, SSIM and proxy
    LPIPS are the plain per-frame computation's to the bit; the eval CLI's
    ``CountingRender`` counts each frame's render."""
    from easy_gaussian_splatting_torch.eval import CountingRender
    from easy_gaussian_splatting_torch.evaluation.evaluator import Evaluator

    arrays, alive, *_ = scene_arrays(rng)
    model = torch_state(arrays, alive, "cpu")[0]
    scene = _Frames(rng)
    cfg = config_from_dict(CFG)
    counting = CountingRender(ttrainer.get_render_fn(cfg))
    ev = Evaluator(1, counting)
    bg = torch.ones(3)
    random.seed(0)
    got = ev.evaluate(scene, "eval", model, 3, bg, num_workers=0)
    assert ev._programs is None
    frame_counts = [int(n) for n in counting.counts]
    assert len(frame_counts) >= scene.nbr_data("eval") and min(frame_counts) > 0
    want = _plain_eval(ev, model, scene, bg)
    for k, v in want.items():
        assert got[k] == v, k
    assert got["render_1"].shape == (H, 2 * W, 3)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures and replays only there")
    return torch.device("cuda")


def _steps(step_fn, model, adam, frames, cfg, device, n=5, mesh=None):
    """``n`` steps in the refine window with a densify event after step 3
    (its growth changes the capacity: a second capture) and an opacity
    reset after step 4; each step's state and loss dict, copied."""
    from easy_gaussian_splatting_torch.models.density import reset_opacities

    loop = ttrainer.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
    gen = torch.Generator(device=device).manual_seed(0)
    if mesh is not None and "gauss" in mesh.axis_names:
        from easy_gaussian_splatting_torch.parallel.gauss_shard import make_sharded_densify_step

        sharded = make_sharded_densify_step(ttrainer._dcfg(cfg), mesh)

        def densify():
            ttrainer.run_sharded_densify_with_growth(loop, sharded, gen, cfg, mesh)
    else:
        plain = ttrainer.make_densify_step(cfg)

        def densify():
            ttrainer.run_densify_with_growth(loop, plain, gen, cfg)
    out = []
    h, w = frames[2].shape[-3:-1]
    for i in range(1, n + 1):
        loop.model, loop.adam, ld = step_fn(loop.model, loop.adam, *frames, 1e-3 / i, True,
                                            i == 4, i == 5, height=h, width=w, sh_degree=3)
        out.append({k: v.clone() for k, v in leaves(loop.model, loop.adam, ld).items()})
        if i == 3:
            densify()
        if i == 4:
            loop.model, loop.adam = reset_opacities(loop.model, loop.adam, cfg.min_opacity)
    return out


@pytest.mark.cuda
def test_graphed_batched_step_equals_eager(cuda, rng):
    """``GraphedTrainStep`` over ``make_batched_train_step``, five steps
    with a densify event that grows the capacity and an opacity reset:
    every step bit for bit the eager batched step's; then another B captures a program of its
    own (B is in the signature), equal to eager too."""
    arrays, alive, w2c, K, _, _ = scene_arrays(rng)
    cfg = config_from_dict(dict(CFG, densify_grad_thresh=0.0, max_capacity=4 * 64))
    render_fn = ttrainer.get_render_fn(cfg)
    eager = ttrainer.make_batched_train_step(cfg, render_fn)
    graphed = graphs.GraphedTrainStep(cfg, eager, cuda)
    for b in (3, 2):
        frames = _batched_frames(w2c, K, np.random.default_rng(b), b=b, device=cuda)
        want = _steps(eager, *torch_state(arrays, alive, cuda), frames, cfg, cuda)
        got = _steps(graphed, *torch_state(arrays, alive, cuda), frames, cfg, cuda)
        for g, w in zip(got, want):
            assert_bitwise(g, w)
    sigs = [c["key"] for c in graphed.captures]
    assert [s[-2] for s in sigs] == [3, 3, 2, 2] and sigs[0][0] != sigs[1][0], sigs


@pytest.mark.cuda
def test_graphed_eval_equals_eager(cuda, rng, monkeypatch):
    """The evaluator's frame and LPIPS programs against the eager
    evaluator: PSNR, SSIM and the proxy LPIPS bit for bit, the kept render
    equal, and ``CountingRender`` fed each replayed frame's count (the
    program's output), equal to the eager renders' counts."""
    from easy_gaussian_splatting_torch.eval import CountingRender
    from easy_gaussian_splatting_torch.evaluation import evaluator as tev

    arrays, alive, *_ = scene_arrays(rng)
    model = torch_state(arrays, alive, cuda)[0]
    scene = _Frames(rng)
    cfg = config_from_dict(CFG)
    bg = torch.ones(3, device=cuda)
    out = {}
    for mode in ("graphed", "eager"):
        counting = CountingRender(ttrainer.get_render_fn(cfg))
        ev = tev.Evaluator(1, counting)
        if mode == "eager":
            monkeypatch.setattr(tev.Evaluator, "_programs_on", lambda self, device: None)
        random.seed(0)
        m = ev.evaluate(scene, "eval", model, 3, bg, num_workers=0)
        out[mode] = (m, [int(n) for n in counting.counts], ev)
    (g, g_counts, ev_g), (e, e_counts, _) = out["graphed"], out["eager"]
    for k in ("psnr", "ssim", "lpips_proxy"):
        assert g[k] == e[k], (k, g[k], e[k])
    np.testing.assert_array_equal(g["render_1"], e["render_1"])
    n = scene.nbr_data("eval")
    # eager: the warm-up, the n frames, 3 latency renders; graphed: the
    # capture's warm-up calls, then the n replayed frames (record)
    assert e_counts[1:1 + n] == g_counts[-n:], (e_counts, g_counts)
    keys = sorted(str(k[0]) for k in ev_g._programs.entries)
    assert keys == ["frame", "lpips"], keys


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tiles:1", "gauss:1", "gauss:1,tiles:1"])
def test_nccl_world_of_one_graphed_equals_eager(cuda, rng, shape):
    """An NCCL world of one rank (the card's machine has one GPU): the
    graphed sharded step against the eager one over five steps with a
    densify event that grows the capacity, bit for bit, with a capture
    for each capacity; the collectives captured and replayed."""
    import torch.distributed as dist

    from easy_gaussian_splatting_torch.parallel import distributed
    from easy_gaussian_splatting_torch.parallel.mesh import mesh_from_shape
    from torch_parallel_worker import free_port

    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0, device=cuda,
                           backend="nccl", timeout_s=120)
    try:
        mesh = mesh_from_shape(shape, cuda)
        arrays, alive, w2c, K, image, mask = scene_arrays(rng)
        frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
        cfg = config_from_dict(dict(CFG, densify_grad_thresh=0.0, max_capacity=4 * 64,
                                    mesh_shape=shape))
        render_fn = ttrainer.get_render_fn(cfg)
        want = _steps(ttrainer.make_mesh_train_step(cfg, mesh, render_fn),
                      *torch_state(arrays, alive, cuda), frame, cfg, cuda, mesh=mesh)
        graphed = graphs.GraphedTrainStep(cfg, ttrainer.make_mesh_train_step(cfg, mesh, render_fn),
                                          cuda, mesh=mesh)
        got = _steps(graphed, *torch_state(arrays, alive, cuda), frame, cfg, cuda, mesh=mesh)
        assert got[-1]["param.means"].shape[0] > 64, "the densify event did not grow the capacity"
        for g, w in zip(got, want):
            assert_bitwise(g, w)
        assert len(graphed.captures) == 2 and sum(graphed.program.collectives.values()) > 0
        graphed.reset()
    finally:
        dist.destroy_process_group()
