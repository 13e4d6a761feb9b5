"""The ``train`` kind: the port's graphed train step
(``training/graphs.py::GraphedTrainStep`` over
``training/trainer.py::make_train_step``) over the seed's late-training
state, called as ``train()`` calls it past ``refine_stop``; on a CPU device
(the tests only) the step runs eagerly, as the program does there."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import cells, inputs
from ..cells import LEAVES
from ..reference import render as ref_render
from ..reference import train as ref_train


class Cell(cells.Cell):
    """The graphed train step over the seed's late-training state."""

    kind = "train"

    def setup(self) -> None:
        from easy_gaussian_splatting_torch.ops.rasterize_tiled import make_isect_counter
        from easy_gaussian_splatting_torch.training.trainer import (
            get_render_fn, make_train_step, tuned_binning)

        sc, dev = self.scene, self.device
        self.h, self.w = sc["height"], sc["width"]
        w2cs, K = inputs.train_views(sc, self.seed)
        self.w2cs = torch.as_tensor(w2cs, device=dev)
        self.K = torch.as_tensor(K, device=dev)
        self.images = inputs.targets(sc, self.seed, dev)
        self.mask = torch.zeros((self.h, self.w), device=dev)
        self.order = inputs.view_order(sc["views"], self.seed, self.mix["max_steps"])
        model, adam = self.state()
        cfg = self.cfg = self.program_cfg()
        # the binning as train()'s autotune sizes it (margin 1.2), on the
        # most intersections any training view has: late in training the
        # watchdog has grown it past every view's
        counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles,
                                     ov_frac=cfg.ov_frac, small_budget=cfg.small_budget)
        vals = torch.stack([counter(model.params, model.alive, self.w2cs[i], self.K,
                                    height=self.h, width=self.w)
                            for i in range(sc["views"])]).amax(0).cpu().numpy()
        cfg.isect_mult, cfg.small_budget, cfg.ov_frac = tuned_binning(
            cfg, vals, model.capacity, 1.2)
        self.isects_tuned = int(vals[0])
        step = make_train_step(cfg, get_render_fn(cfg))
        self.graphed = None
        if dev.type == "cuda":
            from easy_gaussian_splatting_torch.training.graphs import GraphedTrainStep

            step = self.graphed = GraphedTrainStep(cfg, step, dev)
        self.step_fn = step
        self.model, self.adam = model, adam
        self.i = 0  # steps taken
        self.pending: List = []
        self.failed = 0
        self._check_steps()

    def describe(self) -> str:
        c = self.cfg
        return (f"capacity {self.scene['capacity']}, {self.isects_tuned} intersections on the "
                f"fullest view, isect_mult {c.isect_mult}, small_budget {c.small_budget}, "
                f"ov_frac {c.ov_frac}")

    def icap(self) -> int:
        from easy_gaussian_splatting_torch.ops.rasterize_tiled import isect_capacity

        return isect_capacity(self.scene["capacity"], self.cfg.isect_mult)

    def call(self):
        """One step of the traffic, as ``train()`` calls it: the next view
        of the epoch's order, the learning rate of the step, no statistics,
        no refine event, SH degree 3."""
        v = int(self.order[self.i])
        self.i += 1
        step = self.mix["start_step"] + self.i
        self.model, self.adam, ld = self.step_fn(
            self.model, self.adam, self.w2cs[v], self.K, self.images[v], self.mask,
            inputs.means_lr(self.recipe, step), False, False, False,
            height=self.h, width=self.w, sh_degree=self.mix["sh_degree"])
        return ld

    def _readback(self, ld, drain_to: int) -> None:
        """``train()``'s cadence: every ``loss_every``-th step's loss dict
        copied out, read ``loss_lag`` copies later; a read loss that is not
        finite, or a step that binned more intersections than its rows,
        counts as failed."""
        if self.i % self.mix["loss_every"] == 0:
            self.pending.append(cells.Pending(ld, self.device))
        while len(self.pending) > drain_to:
            vals = self.pending.pop(0).get()
            if not math.isfinite(vals["total"]) or vals.get("isects", 0) > self.icap():
                self.failed += 1

    def _check_steps(self) -> None:
        """The first steps of the run, through the window's own call and
        feed (the first captures the step): each step's loss, each leaf's
        first gradient as Adam took it (from the first moment after one
        step) and its change after the three, read from the state."""
        from easy_gaussian_splatting_torch.models.optimizer import BETA1

        p0 = {k: getattr(self.model.params, k).clone() for k in LEAVES}
        mu0 = {k: getattr(self.adam.mu, k).clone() for k in LEAVES}
        losses = []
        for k in range(self.mix["check_steps"]):
            ld = self.call()
            losses.append(float(ld["total"]))
            if k == 0:
                self.prog_grad = {
                    name: float(torch.linalg.norm(
                        (getattr(self.adam.mu, name).double() - BETA1 * mu0[name].double())
                        / (1.0 - BETA1)))
                    for name in LEAVES}
                del mu0
        self.prog_change = {k: float(torch.linalg.norm(
            getattr(self.model.params, k).double() - p0[k].double())) for k in LEAVES}
        self.prog_losses = losses
        del p0

    def window(self, seconds: float) -> dict:
        """Steps back to back for ``seconds``, then one synchronize: the
        views trained, the wall time and the host time of each call."""
        dev = self.device
        start = self.i
        dispatch = 0.0
        cells.sync(dev)
        with record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                with record_function("train.dispatch"):
                    t = time.perf_counter()
                    ld = self.call()
                    dispatch += time.perf_counter() - t
                with record_function("train.readback"):
                    self._readback(ld, self.mix["loss_lag"])
                if time.perf_counter() - t0 >= seconds:
                    break
            with record_function("bench.sync"):
                self._readback(ld, 0)
                cells.sync(dev)
            wall = time.perf_counter() - t0
        n = self.i - start
        return dict(units=n, wall_s=wall, dispatch_ms=dispatch / n * 1e3,
                    train_views_per_s=n / wall)

    def traced_units(self, n: int) -> None:
        """``n`` steps for the profiler, their loss dicts read back at the
        cadence."""
        for _ in range(n):
            with record_function("train.dispatch"):
                ld = self.call()
            with record_function("train.readback"):
                self._readback(ld, self.mix["loss_lag"])
        with record_function("bench.sync"):
            self._readback(ld, 0)

    def unit_views(self, first: int, n: int) -> List[int]:
        return [int(v) for v in self.order[first:first + n]]

    def work_counts(self, views: List[int]) -> List[dict]:
        """The compositing work each of ``views`` needs on the current state
        (the reference's binning and walk) and the step's byte and operation
        counts."""
        from ..yardstick import step_bytes, step_ops

        n = self.scene["gaussians"]
        params = {k: getattr(self.model.params, k)[:n].detach() for k in LEAVES}
        out = []
        for v in views:
            _, c = ref_render.render(params, self.w2cs[v], self.K, self.w, self.h,
                                     self.background, self.recipe["tile_size"],
                                     self.recipe["max_tiles"], counts=True)
            c["step_bytes"] = step_bytes(n, c["live_rows"], self.h, self.w)
            c["step_ops"] = step_ops(n, self.h, self.w, c["composited"])
            out.append(c)
        return out

    def captures(self) -> int:
        return 0 if self.graphed is None else len(self.graphed.captures)

    def release(self) -> None:
        if self.graphed is not None:
            self.graphed.reset()
        self.graphed = self.step_fn = self.model = self.adam = None
        self.pending = []

    def reference(self, tf32: bool = False, loss_rows: int | None = None) -> dict:
        """The reference's readings of the first steps from the seed's own
        inputs: float64 (float32 with TF32 products for the control)."""
        dev = self.device
        hi = torch.float32 if tf32 else torch.float64
        g = inputs.gaussians(self.scene, self.seed, dev)
        mu, nu = inputs.moments(self.scene, self.config["adam"], self.seed, dev)
        views_i = [int(v) for v in self.order[:self.mix["check_steps"]]]
        views = [(self.w2cs[v], self.K, self.images[v]) for v in views_i]
        lrs = [inputs.learning_rates(self.recipe, self.mix["start_step"] + k + 1)
               for k in range(len(views))]
        p0 = {k: v.to(hi) for k, v in g.items()}
        losses, first, p3 = ref_train.follow(
            p0, {k: v.to(hi) for k, v in mu.items()}, {k: v.to(hi) for k, v in nu.items()},
            self.config["adam"]["steps"], views, lrs, width=self.w, height=self.h,
            background=self.background, lambda_ssim=self.recipe["lambda_ssim"],
            tile_size=self.recipe["tile_size"], max_tiles=self.recipe["max_tiles"],
            tf32=tf32, loss_rows=loss_rows)
        return dict(losses=losses,
                    grad={k: float(torch.linalg.norm(first[k].double())) for k in LEAVES},
                    change={k: float(torch.linalg.norm((p3[k] - p0[k]).double()))
                            for k in LEAVES})

    def compare(self, ref: dict, got: dict | None = None) -> Dict[str, float]:
        """The numbers that decide ``correct``: the worst step's relative
        loss gap, the worst leaf's first-gradient gap, and the worst leaf's
        gap in the change after the first steps, over the leaves whose
        reference gradient is more than a thousandth of the median leaf's
        (the others move by round-off alone)."""
        got = got or dict(losses=self.prog_losses, grad=self.prog_grad,
                          change=self.prog_change)
        med = float(np.median([ref["grad"][k] for k in LEAVES]))
        moving = [k for k in LEAVES if ref["grad"][k] > 1e-3 * med]
        return {
            "loss_gap": max(cells.rel_gap(a, b, 0.0) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": cells.leaf_gaps(got["grad"], ref["grad"], LEAVES),
            "change_gap": cells.leaf_gaps(got["change"], ref["change"], moving),
        }
