"""The comparison of ``tandt_db.train_densify`` has to fail what is wrong in
the densify phase: runs of the cell on the CPU at a small size with a fault
planted underneath the program (one step's statistics left out, the split
noise zeroed, the large-radius prune skipped, the parameters left as they
were by Adam's steps, which still update the moments), and the control (the
reference in float32 with TF32 products in the program's place). The
faults are planted where the graphed step and event run them too, so the
same helpers plant them on the card.

    python -m pytest benchmark/tests/test_train_densify.py -q -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import calibrate, cells, run
from benchmark.tests.test_benchmark_harness import SPEC, small

CELL = "tandt_db.train_densify"
FAULTS = ("stats_step", "noise", "radii_prune", "unchanged")


def plant(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the port: ``stats_step`` leaves the second step's
    statistics out (the flag the loop hands the step, eager or graphed),
    ``noise`` zeroes the split noise and ``radii_prune`` skips the
    large-radius prune (both in the event's ``densify_and_prune``, which the
    graphed event captures) and ``unchanged`` gives Adam's update of the
    parameters a learning rate of 0 (in the step's ``adam_update``, which the
    graphed step captures: the moments move, the parameters do not)."""
    from easy_gaussian_splatting_torch.training import trainer

    if fault == "unchanged":
        update = trainer.adam_update

        def frozen(params, grads, state, lrs, *a, **kw):
            return update(params, grads, state, {k: 0.0 * v for k, v in lrs.items()}, *a, **kw)

        monkeypatch.setattr(trainer, "adam_update", frozen)
        return

    if fault == "stats_step":
        calls = [0]

        def skip(do_stats):
            calls[0] += 1
            return False if calls[0] == 2 else do_stats

        make = trainer.make_train_step

        def make_skipping(cfg, render_fn):
            step = make(cfg, render_fn)

            def train_step(model, adam, w2c, K, image, mask, lr, do_stats, *a, **kw):
                if kw.get("in_place"):  # inside the graphed step: its flag is set there
                    return step(model, adam, w2c, K, image, mask, lr, do_stats, *a, **kw)
                return step(model, adam, w2c, K, image, mask, lr, skip(do_stats), *a, **kw)

            return train_step

        class Skipping(trainer.GraphedTrainStep):
            def __call__(self, model, adam, w2c, K, image, mask, lr, do_stats, *a, **kw):
                return super().__call__(model, adam, w2c, K, image, mask, lr, skip(do_stats),
                                        *a, **kw)

        monkeypatch.setattr(trainer, "make_train_step", make_skipping)
        monkeypatch.setattr(trainer, "GraphedTrainStep", Skipping)
        return
    densify = trainer.densify_and_prune

    def faulty(state, adam, generator, dcfg, noise=None):
        if fault == "noise":
            return densify(state, adam, None, dcfg,
                           noise=torch.zeros((state.capacity, 3), device=state.alive.device))
        return densify(state, adam, generator,
                       dataclasses.replace(dcfg, prune_radii_ratio_thresh=float("inf")), noise)

    monkeypatch.setattr(trainer, "densify_and_prune", faulty)


def overrides(fault: str | None = None) -> dict:
    """The cell's small size; for the noise fault, 300 Gaussians (the
    generator's scales shrink with the cube root of the count, so a split's
    offset, a scale times the noise, is then a few hundredths of a position
    instead of a few thousandths) and a split threshold of 0.1 (at the
    configured 0.5 the small size splits none, and the noise would reach no
    Gaussian)."""
    ov = small(CELL)
    if fault == "noise":
        ov["scene"] = dict(ov["scene"], gaussians=300, capacity=1024)
        ov["recipe"] = {"densify_scale_thresh": 0.1}
    return ov


def program_readings(ov: dict, seed: int = 31):
    """The program's numbers against the reference on a small run, and the
    check event's counts."""
    _, config, mix, _ = run.cell_files(SPEC, CELL, ov)
    c = cells.kind(mix["kind"])(config, mix, seed, torch.device("cpu"))
    c.setup()
    c.release()
    return c.compare(c.reference()), c.prog["info"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(monkeypatch, fault):
    limits = run.cell_files(SPEC, CELL)[3]
    if fault == "noise":  # the run it is planted under splits, and is correct without it
        numbers, info = program_readings(overrides(fault))
        assert info["split"] > 0, info
        assert all(numbers[k] <= v["limit"] for k, v in limits.items()), numbers
    plant(monkeypatch, fault)
    numbers, info = program_readings(overrides(fault))
    assert any(numbers[k] > v["limit"] for k, v in limits.items()), (numbers, info)


def test_control_fails_and_the_program_passes():
    limits = run.cell_files(SPEC, CELL)[3]
    r = calibrate.readings(SPEC, CELL, 32, True, "cpu", small(CELL))
    assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
    assert any(r["control"][k] > v["limit"] for k, v in limits.items()), r
    assert any(r["half_batch"][k] > v["limit"] for k, v in limits.items()), r


def test_target_blend_mixes_the_render_in():
    """``target_blend`` b: each target is b of the procedural image and 1 - b
    of the port's render of the seeded state at that view."""
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn

    ov = small(CELL)
    ov["traffic"] = {"target_blend": 0.25}
    _, config, mix, _ = run.cell_files(SPEC, CELL, ov)
    c = cells.kind(mix["kind"])(config, mix, 33, torch.device("cpu"))
    w2cs, K = cells.inputs.train_views(c.scene, c.seed)
    c.w2cs, c.K = torch.as_tensor(w2cs), torch.as_tensor(K)
    c.h, c.w = c.scene["height"], c.scene["width"]
    model, _ = c.state()
    got = c._targets(model)
    procedural = cells.inputs.targets(c.scene, c.seed, "cpu")
    cfg = c.program_cfg()
    cfg.isect_mult = 8.0  # rows for every intersection of the small frame
    with torch.no_grad():
        image = get_render_fn(cfg)(model.params, model.alive,
                                   CameraView(w2c=c.w2cs[1], K=c.K, width=c.w, height=c.h),
                                   3, c.background, None).image
    torch.testing.assert_close(got[1], 0.25 * procedural[1] + 0.75 * image, rtol=0, atol=1e-6)
    assert (got[1] - procedural[1]).abs().max() > 0.05


def test_refine_metrics_read_the_event_alone():
    """On a made-up trace: the event's own device operations start at its
    noise kernel (the queued steps' before it are not the event's), its cost
    on the loop runs from there to the end of ``train.loop.densify``, and the
    step metrics leave the event's operations out."""
    from benchmark import refine
    from benchmark.trace import Window

    device = [("step", 0.000, 0.008, "kernel"), ("step", 0.008, 0.008, "kernel"),
              ("void at::native::normal_kernel", 0.016, 0.001, "kernel"),
              ("where", 0.017, 0.002, "kernel"), ("Memcpy DtoH", 0.019, 0.0001, "gpu_memcpy"),
              ("step", 0.025, 0.008, "kernel")]
    spans = [("bench.window", 0.0, 0.04), ("train.loop.densify", 0.010, 0.012),
             ("train.refine.event", 0.010, 0.0095)]
    w = Window(device, spans, 0.0, 0.04, 2, True)
    assert refine.event_ms(w) == pytest.approx(3.1)
    assert refine.critical_ms(w) == pytest.approx(6.0)
    assert [d[0] for d in refine.steps_only(w).device] == ["step"] * 3
    c = dict(capacity=100, num_splits=2, event=dict(split=1, clone=2, prune_low_opacity=0,
                                                    prune_large_radii=1, prune_large_scale=0))
    assert refine.event_bytes(c) == (100 * (29 + 12) + 3 * 236 + 4 * (3 * 236 + 1) + 2)
