"""The comparison that decides ``correct`` has to fail what is wrong: runs
of the harness on the CPU at a small size, the look for a card skipped,
with the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out of the loss, an answer altered
where it is produced, a fault in the port's projection, planted in the
copy the reference bins on too, or in its SH), and the control: the reference in the program's
place at the precision below the configured one (matrix products in
TF32), which has to fail one of each cell's numbers under the cell's own
limits. One test on the card (marked ``cuda``) runs the command itself.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests.test_benchmark_harness import ROOT, SPEC, small

CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [c for c in CELLS if run.cell_files(SPEC, c)[2]["kind"] == "train"]
SERVE = [c for c in CELLS if run.cell_files(SPEC, c)[2]["kind"] == "serve"]


def run_small(cell: str, seed: int = 9):
    res, checks = run.run_cell(SPEC, cell, seed, 0.3, False, "cpu", small(cell))
    return res["correct"], checks


def broken_step(kind: str):
    """``make_train_step`` with a planted fault."""
    from easy_gaussian_splatting_torch.training import trainer

    make = trainer.make_train_step

    def make_broken(cfg, render_fn):
        step = make(cfg, render_fn)

        def train_step(model, adam, *args, **kw):
            new_model, new_adam, ld = step(model, adam, *args, **kw)
            if kind == "unchanged":
                return model, adam, ld
            return new_model, new_adam, ld

        return train_step

    return make_broken


def broken_loss(kind: str):
    """``loss_dict`` with a planted fault: the loss over the first half of
    the rows only, or its value altered where it is produced."""
    from easy_gaussian_splatting_torch.training import trainer

    loss_dict = trainer.loss_dict

    def wrapped(render_img, gt_img, mask, *args, **kw):
        if kind == "half":
            h = render_img.shape[0] // 2
            return loss_dict(render_img[:h], gt_img[:h], mask[:h], *args, **kw)
        out = loss_dict(render_img, gt_img, mask, *args, **kw)
        out["total"] = out["total"] * 1.01
        return out

    return wrapped


class _Closure:
    """The served closure with a planted fault; its attributes are the
    real closure's."""

    def __init__(self, inner, kind: str):
        self.inner, self.kind, self.first = inner, kind, None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, camera):
        image = self.inner(camera)
        if self.kind == "unchanged":  # every frame the first one
            if self.first is None:
                self.first = image
            return self.first.copy()
        image = image.copy()
        if self.kind == "half":  # the lower half never rendered
            image[image.shape[0] // 2:] = 0.5
        else:  # one 16x16 block altered
            image[:16, :16] = np.clip(image[:16, :16] + 0.25, 0.0, 1.0)
        return image


def broken_render(kind: str):
    from easy_gaussian_splatting_torch.viewer import integration

    make = integration.make_gs_render_func
    return lambda *a, **kw: _Closure(make(*a, **kw), kind)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_step_fault_fails(monkeypatch, cell):
    from easy_gaussian_splatting_torch.training import trainer

    monkeypatch.setattr(trainer, "make_train_step", broken_step("unchanged"))
    correct, checks = run_small(cell)
    assert not correct, checks


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_loss_fault_fails(monkeypatch, cell, fault):
    from easy_gaussian_splatting_torch.training import trainer

    monkeypatch.setattr(trainer, "loss_dict", broken_loss(fault))
    correct, checks = run_small(cell)
    assert not correct, checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", SERVE)
def test_served_frame_fault_fails(monkeypatch, cell, fault):
    from easy_gaussian_splatting_torch.viewer import integration

    monkeypatch.setattr(integration, "make_gs_render_func", broken_render(fault))
    correct, checks = run_small(cell)
    assert not correct, checks


def broken_projection(monkeypatch, scale: float) -> None:
    """The port's projection with its conics scaled, and the same fault in
    the frozen copy the reference bins on: the reference's values have to
    judge it by themselves."""
    from easy_gaussian_splatting_torch.models import render as port_render

    from benchmark.reference import program32

    port, copy = port_render.project_gaussians, program32.project_gaussians

    def port_broken(*a, **kw):
        p = port(*a, **kw)
        return p._replace(conics=p.conics * scale)

    def copy_broken(*a, **kw):
        mean2d, conic, z, radius = copy(*a, **kw)
        return mean2d, conic * scale, z, radius

    monkeypatch.setattr(port_render, "project_gaussians", port_broken)
    monkeypatch.setattr(program32, "project_gaussians", copy_broken)


@pytest.mark.parametrize("fault", ["projection", "sh"])
@pytest.mark.parametrize("cell", CELLS)
def test_port_projection_or_sh_fault_fails(monkeypatch, cell, fault):
    """The port's conics scaled, planted in the copy the reference bins on
    too, or its SH colours off by 1%: the reference's values are its own."""
    from easy_gaussian_splatting_torch.models import render as port_render

    if fault == "projection":
        broken_projection(monkeypatch, 0.95)
    else:
        sh = port_render.eval_sh_color_flat
        monkeypatch.setattr(port_render, "eval_sh_color_flat",
                            lambda *a, **kw: sh(*a, **kw) * 1.01)
    correct, checks = run_small(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The control on three seeds: each fails at least one of the cell's
    numbers under its limits, while the program's runs pass."""
    limits = run.cell_files(SPEC, cell)[3]
    for seed in (21, 22, 23):
        r = calibrate.readings(SPEC, cell, seed, True, "cpu", small(cell))
        assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
        assert any(r["control"][k] > v["limit"] for k, v in limits.items()), r


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_command_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", TRAIN[0], "--seed",
                          "4000000007", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"train_views_per_s", "peak_mem_gib", "setup_s"}
