"""``train()`` one iteration at a time (``training/trainer.py::iter_train``)
and the densify phase the benchmark's ``tandt_db.train_densify`` cell
measures through it: draining the generator is ``train()`` bit for bit
across refine events and an opacity reset, ``start=`` continues a state in
memory as ``resume_from=`` continues its checkpoint, the loop counters add
up to the events' counts, the refine spans reach the profiler, and the
benchmark's plain reference of the statistics, the event and the reset
(``benchmark/reference/densify.py``) agrees with the port's.

    python -m pytest tests/test_torch_train_densify.py -q -p no:cacheprovider
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import densify as ref
from easy_gaussian_splatting_torch.models import density as td
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.models import optimizer as to
from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict
from easy_gaussian_splatting_torch.utils.checkpoint import save_checkpoint

H, W = 32, 48
N, CAP = 60, 96
NAMES = tg.PARAM_NAMES
# an event every 2 steps from step 2, a reset at step 4
CFG = dict(renderer="tiled", tile_size=16, white_background=True, lambda_ssim=0.2,
           sh_degree=3, sh_degree_interval=0, data_device_cache=False, dataloader_workers=0,
           refine_start=0, refine_every=2, reset_opacities_every=4, refine_stop=100,
           densify_grad_thresh=2e-4, densify_scale_thresh=0.1, initial_capacity=CAP,
           total_iterations=6)
RECIPE = ("densify_grad_thresh", "densify_scale_thresh", "num_splits", "min_opacity",
          "prune_radii_ratio_thresh", "prune_scale_thresh")


class _Scene:
    """Two cameras around a point cloud; frames as numpy."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        xyzs = rng.uniform(-0.6, 0.6, size=(N, 3)).astype(np.float32)
        self.pc = SimpleNamespace(xyzs=xyzs, rgbs=rng.integers(0, 256, size=(N, 3)).astype(
            np.uint8), nbr_points=N)
        K = np.array([[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]], np.float32)
        self.frames = []
        for dx in (0.05, -0.15):
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, 3] = [dx, -0.1, 4.0]
            self.frames.append(dict(K=K, height=H, width=W, w2c=w2c, mask=np.zeros((H, W),
                                    np.float32), image=rng.uniform(size=(H, W, 3)).astype(
                                        np.float32)))

    def nbr_data(self, split):
        return 50 if split == "train" else 0

    def get_data(self, split, index):
        return dict(self.frames[index % 2])


def _state(loop):
    out = {f"param.{k}": getattr(loop.model.params, k) for k in NAMES}
    out["alive"] = loop.model.alive
    out.update({f"stats.{f.name}": getattr(loop.model.stats, f.name)
                for f in dataclasses.fields(tg.DensifyStats)})
    out.update({f"mu.{k}": getattr(loop.adam.mu, k) for k in NAMES})
    out.update({f"nu.{k}": getattr(loop.adam.nu, k) for k in NAMES})
    out.update({f"steps.{k}": loop.adam.steps[k] for k in NAMES})
    return out


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_draining_iter_train_is_train_bit_for_bit():
    random.seed(0)
    want = ttrainer.train(config_from_dict(CFG), scene=_Scene(), device="cpu")
    random.seed(0)
    run = ttrainer.iter_train(config_from_dict(CFG), scene=_Scene(), device="cpu")
    steps, losses = [], []
    for loop in run:
        steps.append(loop.step)
        losses.append(float(loop.losses["total"]))
    assert steps == list(range(1, 7)) and all(np.isfinite(losses))
    assert loop.model.num_alive() > N  # the events cloned
    _equal(_state(loop), _state(want))


def test_start_continues_as_resume_from_a_checkpoint(tmp_path):
    random.seed(1)
    cfg = dict(CFG, total_iterations=2)
    mid = ttrainer.train(config_from_dict(cfg), scene=_Scene(), device="cpu")
    mid.model = dataclasses.replace(mid.model, stats=tg.zero_stats(mid.model.capacity, "cpu"))
    path = tmp_path / "mid.npz"
    save_checkpoint(path, mid.model, mid.active_sh_degree, mid.step, adam=mid.adam)
    random.seed(2)
    want = ttrainer.train(config_from_dict(CFG), scene=_Scene(), resume_from=str(path),
                          device="cpu")
    random.seed(2)
    start = ttrainer.TrainLoopState(model=mid.model, adam=mid.adam,
                                    active_sh_degree=mid.active_sh_degree, step=mid.step)
    run = ttrainer.iter_train(config_from_dict(CFG), scene=_Scene(), device="cpu", start=start)
    for loop in run:
        pass
    assert loop.step == want.step == 6
    _equal(_state(loop), _state(want))
    with pytest.raises(ValueError, match="not both"):
        next(ttrainer.iter_train(config_from_dict(CFG), scene=_Scene(), device="cpu",
                                 start=start, resume_from=str(path)))


def test_loop_counts_add_up_to_the_events(monkeypatch):
    infos, grown = [], []
    event = ttrainer.run_densify_with_growth

    def recorded(loop, *a, **kw):
        cap = loop.model.capacity
        infos.append(event(loop, *a, **kw))
        grown.append(loop.model.capacity != cap)
        return infos[-1]

    monkeypatch.setattr(ttrainer, "run_densify_with_growth", recorded)
    graphs.reset_loop_counts()
    random.seed(0)
    ttrainer.train(config_from_dict(CFG), scene=_Scene(), device="cpu")
    counts = graphs.loop_counts()
    assert counts["refine_events"] == len(infos) == 3
    for k in ("split", "clone", "prune_low_opacity", "prune_large_radii", "prune_large_scale"):
        assert counts[k] == sum(i[k] for i in infos), k
    assert counts["clone"] + counts["split"] > 0
    assert counts["losses_nonfinite"] == 0
    # the 96 slots overflow at each event: the state grows (and retries)
    assert counts["capacity_changes"] == sum(grown) > 0
    assert counts["event_overflows"] >= sum(grown) and counts["isect_overflows"] == 0
    assert counts["captures"] == 0  # eager on the CPU: nothing captured
    graphs.reset_loop_counts()
    assert set(graphs.loop_counts().values()) == {0}


def test_refine_spans_reach_the_profiler():
    random.seed(0)
    run = ttrainer.iter_train(config_from_dict(CFG), scene=_Scene(), device="cpu")
    next(run)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):  # steps 2-4: two events and the reset
            next(run)
    run.close()
    names = {e.key for e in prof.key_averages()}
    assert {"train.refine.event", "train.refine.isects", "train.refine.warm",
            "train.reset", "train.loop.densify"} <= names, sorted(n for n in names if "train" in n)


def _random_state(seed: int, cap: int = 512):
    """A float32 state of ``cap`` slots, about 70% alive, with statistics
    whose decisions lie clear of the thresholds (so that rounding moves
    none of them) and some Gaussians to split, clone and prune for each
    reason."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    alive = u(cap) < 0.7
    q = torch.randn((cap, 4), generator=g)
    params = tg.GaussianParams(
        means=u(cap, 3) * 4 - 2, log_scales=u(cap, 3) * 4 - 5, quats=q,
        sh_0=torch.randn((cap, 1, 3), generator=g), sh_rest=torch.randn((cap, 15, 3),
                                                                      generator=g) * 0.2,
        logit_opacities=u(cap) * 12 - 8)
    # max scale at least 0.03 off the 0.1 split and 0.3 prune thresholds
    ls = params.log_scales
    for thresh in (0.1, 0.3):
        m = ls.exp().amax(-1)
        ls -= torch.where((m - thresh).abs() < 0.03, 0.4, 0.0)[:, None]
    counts = torch.floor(u(cap) * 5)
    grad = counts * torch.where(u(cap) < 0.4, 3e-4, 1e-4)
    # opacity at least 20% off min_opacity; radii off the 0.15 threshold
    lo = params.logit_opacities
    op = torch.sigmoid(lo)
    lo += torch.where((op / 0.005 - 1).abs() < 0.2, 2.0, 0.0)
    radii = torch.where(u(cap) < 0.2, 0.2, 0.1)
    model = tg.GaussianModelState(params=params, alive=alive,
                                  stats=tg.DensifyStats(grad, counts, radii))
    mu = params.map(lambda x: torch.randn(x.shape, generator=g) * 1e-3)
    nu = params.map(lambda x: torch.rand(x.shape, generator=g) * 1e-5)
    adam = to.AdamState(mu=mu, nu=nu, steps={k: torch.tensor(7, dtype=torch.int32)
                                             for k in NAMES})
    return model, adam


def _tree(t):
    return {k: getattr(t, k).double() for k in NAMES}


# the reference is float64 on the same float32 inputs; the port rounds each
# operation to float32 once (the split's offset, the shrunk log-scale and the
# reset's logit a few operations each), so a slot agrees to a few float32 ulp
RTOL, ATOL = 2e-6, 1e-6


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_agrees_with_the_port(seed):
    cfg = config_from_dict(dict(CFG, prune_scale_thresh=0.3))
    dcfg = ttrainer._dcfg(cfg)
    recipe = {k: getattr(cfg, k) for k in RECIPE}
    model, adam = _random_state(seed)
    cap = model.capacity
    g = torch.Generator().manual_seed(seed + 100)
    # statistics: one view's radii and absolute screen gradients added
    radii = torch.where(torch.rand(cap, generator=g) < 0.8, torch.rand(cap, generator=g) * 5,
                        torch.zeros(cap))
    absgrad = torch.rand((cap, 2), generator=g) * 1e-5
    stats = td.update_statistics(model.stats, radii, absgrad, H, W)
    want = ref.update_statistics(
        {"grad": model.stats.grad_norm_accum.double(),
         "count": model.stats.collecting_counts.double(),
         "max_radii": model.stats.max_radii.double()}, radii.double(), absgrad.double(), H, W)
    for k, f in zip(ref.STATS, ("grad_norm_accum", "collecting_counts", "max_radii")):
        torch.testing.assert_close(getattr(stats, f).double(), want[k], rtol=RTOL, atol=1e-12)
    model = dataclasses.replace(model, stats=stats)
    # the event with the same noise
    noise = torch.randn((cap, 3), generator=g)
    new_model, new_adam, info, overflow = td.densify_and_prune(model, adam, None, dcfg,
                                                               noise=noise)
    p, m, v, alive, ref_info, ref_overflow = ref.densify_and_prune(
        _tree(model.params), _tree(adam.mu), _tree(adam.nu), model.alive,
        {k: want[k] for k in ref.STATS}, noise.double(), recipe)
    assert not bool(overflow) and not ref_overflow
    assert {k: int(x) for k, x in info.items()} == ref_info
    assert min(ref_info[k] for k in ("split", "clone", "prune_low_opacity",
                                     "prune_large_radii", "prune_large_scale")) > 0, ref_info
    assert torch.equal(new_model.alive, alive)
    for got, tree in ((new_model.params, p), (new_adam.mu, m), (new_adam.nu, v)):
        for k in NAMES:
            torch.testing.assert_close(getattr(got, k).double(), tree[k], rtol=RTOL, atol=ATOL)
    # the reset
    reset_model, reset_adam = td.reset_opacities(new_model, new_adam, cfg.min_opacity)
    p2, m2, v2 = ref.reset_opacities(p, m, v, cfg.min_opacity)
    for got, tree in ((reset_model.params, p2), (reset_adam.mu, m2), (reset_adam.nu, v2)):
        for k in NAMES:
            torch.testing.assert_close(getattr(got, k).double(), tree[k], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_each_capture_is_counted():
    """``Programs.prepare`` counts each capture in the loop counters, and
    not a program it already holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures only there")
    dev = torch.device("cuda")
    progs = graphs.Programs(dev, 2, "a test program")
    x = torch.ones(8, device=dev)
    graphs.reset_loop_counts()
    for key in ("a", "b", "a"):
        progs.run(key, lambda bufs: bufs[0] * 2.0, [x])
    assert graphs.loop_counts()["captures"] == len(progs.captures) == 2
    progs.reset()
    graphs.reset_loop_counts()
