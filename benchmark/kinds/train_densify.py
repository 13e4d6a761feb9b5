"""The ``train_densify`` kind: ``train()`` itself in the densify phase of the
recipe, driven one iteration at a time
(``training/trainer.py::iter_train``) from the seed's state at
``start_step``, as ``train()`` continues a run: statistics on every step, a
refine event every ``refine_every`` steps, the loss read back every 10th
step three behind, the intersection watchdog and the capture ahead, all
the loop's own.

The scene is the seed's views on the device (``inputs.train_views``),
served by index in ``train()``'s own shuffle of a tiling of ``max_steps``
frames (Python's ``random``, seeded from the seed), each target
``target_blend`` b of ``inputs.targets`` and 1 - b of the port's render of
the seeded state at that view.

- Set-up: the first ``check_steps`` steps, the last one carrying a refine
  event (``start_step`` + ``check_steps`` is an event step), whose readings
  the comparison takes: each step's loss, the first step's gradient (from
  Adam's first moment), the parameters the event read (on the host), the
  statistics it read, its counts and the state it left. Then a snapshot of
  that state on the device (model, Adam state, zero statistics) and the
  warm-up, the same length on every seed: whole refine periods from the
  snapshot that serve each view once in order, then one period in the
  loop's own shuffle, which has to pass with no capture, no binning
  rebuild and no capacity change (else one more, at most
  ``WARM_PERIODS`` in all). The warm-up's first event, which reads a whole
  period's statistics and splits, is also read: the state, statistics and
  generator it started from (on the host), its counts and what it did,
  for the reference to take the same event from the same inputs.
- The window: whole periods, each the snapshot restored into the loop's
  own tensors and ``refine_every`` steps, the last one the event, until
  ``seconds`` have passed; the views trained over the wall time.
- Outside the wall, steps up to five before the next event, so that the
  traced steps hold the event; the state there is kept in the snapshot's
  tensors, so that a traced window profiled again starts from the same
  statistics.

A step of the window or of the steps after it counts as failed when a loss
``train()`` read back is not finite, when the watchdog saw the binned
intersections overflow their rows, and when an event overflowed its free
slots or changed the capacity (``graphs.loop_counts``).
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import cells, inputs
from ..cells import LEAVES
from ..reference import densify as ref_densify
from . import train as train_kind

WARM_PERIODS = 6  # the warm-up's most periods
CPU_PERIOD = 5  # the refine period on a CPU device (the tests': a plain-kernel step takes ~1 s)
GROUPS = ("params", "mu", "nu")
STAT_FIELDS = ("grad_norm_accum", "collecting_counts", "max_radii")  # ref_densify.STATS'
LEAD = 5  # traced steps before the event


class _Views:
    """The scene ``iter_train`` reads: ``steps`` frames, a tiling of the
    views, each one's tensors on the device; ``served`` lists the view of
    each frame served, in order. While ``queue`` holds views, a frame asked
    for serves the next of them instead."""

    def __init__(self, w2cs, K, images, steps: int):
        self.w2cs, self.K, self.images = w2cs, K, images
        self.h, self.w = images.shape[1], images.shape[2]
        self.mask = torch.zeros((self.h, self.w), device=images.device)
        self.steps, self.served, self.queue = steps, [], []

    def nbr_data(self, split: str) -> int:
        return self.steps if split == "train" else 0

    def get_data(self, split: str, index: int) -> dict:
        v = self.queue.pop(0) if self.queue else index % self.images.shape[0]
        self.served.append(v)
        return dict(w2c=self.w2cs[v], K=self.K, image=self.images[v], mask=self.mask,
                    height=self.h, width=self.w)


@contextlib.contextmanager
def _reading_events(read):
    """``train()``'s refine events run through ``read(loop, generator,
    event)``, ``event()`` running the event (``run_densify_with_growth``)
    and returning its counts."""
    from easy_gaussian_splatting_torch.training import trainer

    event = trainer.run_densify_with_growth

    def wrapped(loop, densify_step, generator, *a, **kw):
        return read(loop, generator, lambda: event(loop, densify_step, generator, *a, **kw))

    trainer.run_densify_with_growth = wrapped
    try:
        yield
    finally:
        trainer.run_densify_with_growth = event


def _norm(x: torch.Tensor, rows: torch.Tensor) -> float:
    return float(torch.linalg.norm(x[rows].double()))


def _state_norms(params, mu, nu, rows, pre=None) -> Dict[str, Dict[str, float]]:
    """Each leaf's norm over the slots ``rows`` (a bool mask), per group, of
    the state or, with ``pre``, of its change from ``pre`` (in the slots of
    a capacity grown since, from a dead slot's values)."""
    out = {}
    for g, tree in zip(GROUPS, (params, mu, nu)):
        out[g] = {k: _norm(tree[k] if pre is None else
                           _less(tree[k], pre[g][k], g == "params" and k == "quats"), rows)
                  for k in LEAVES}
    return out


def _less(x: torch.Tensor, pre: torch.Tensor, quats: bool) -> torch.Tensor:
    out = x.clone()
    out[:pre.shape[0]] -= pre
    if quats:  # a dead slot's quaternion is the identity
        out[pre.shape[0]:, 0] -= 1.0
    return out


def _key(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A Gaussian's key: the float32 bits of its opacity and first colour
    coefficient, which a clone or a split child copies from its parent (the
    same key in either precision for values the program's float32 holds)."""
    bits = [x.float().contiguous().view(torch.int32).to(torch.int64)
            for x in (params["logit_opacities"], params["sh_0"][:, 0, 0])]
    return bits[0] ^ (bits[1] * 0x1E3779B97F4A7C15)


def _split_offset(pre: Dict[str, torch.Tensor], pre_alive: torch.Tensor,
                  post: Dict[str, torch.Tensor], post_alive: torch.Tensor) -> float:
    """The norm of the split children's offsets from their parents: each
    Gaussian alive after the event that is not one alive before with its
    position and scales unchanged, found by its key among those alive
    before (of equal keys the one in the lowest slot, on either side), and a
    child where its scales shrank."""
    c = pre_alive.shape[0]
    kept = (pre_alive & post_alive[:c] & (post["means"][:c] == pre["means"]).all(-1)
            & (post["log_scales"][:c] == pre["log_scales"]).all(-1))
    new = post_alive.clone()
    new[:c] &= ~kept
    rows = torch.nonzero(pre_alive).squeeze(1)
    keys, order = torch.sort(_key(pre)[rows], stable=True)  # equal keys: the lowest slot
    want = _key(post)[new]
    at = torch.clamp(torch.searchsorted(keys, want), max=keys.shape[0] - 1)
    parent = rows[order[at]]
    child = (keys[at] == want) & (post["log_scales"][new].sum(-1)
                                  < pre["log_scales"][parent].sum(-1))
    return float(torch.linalg.norm((post["means"][new] - pre["means"][parent])[child].double()))


def _event_readings(pre: Dict[str, torch.Tensor], pre_alive: torch.Tensor,
                    post: Dict[str, torch.Tensor], post_alive: torch.Tensor) -> dict:
    """What an event did to the parameters: each leaf's norm of the change
    over the slots alive after it, and the norm of the split children's
    offsets from their parents."""
    return dict(change={k: _norm(_less(post[k], pre[k], k == "quats"), post_alive)
                        for k in LEAVES},
                split=_split_offset(pre, pre_alive, post, post_alive))


def _trees(model, adam):
    return ({k: getattr(model.params, k) for k in LEAVES},
            {k: getattr(adam.mu, k) for k in LEAVES}, {k: getattr(adam.nu, k) for k in LEAVES})


class Cell(train_kind.Cell):
    """``train()`` over the seed's state in the densify phase."""

    kind = "train"  # a train cell to the calibration: reference(tf32, loss_rows), compare

    def setup(self) -> None:
        from easy_gaussian_splatting_torch.training import graphs, trainer

        sc, dev, mix = self.scene, self.device, self.mix
        self.h, self.w = sc["height"], sc["width"]
        w2cs, K = inputs.train_views(sc, self.seed)
        self.w2cs = torch.as_tensor(w2cs, device=dev)
        self.K = torch.as_tensor(K, device=dev)
        model, adam = self.state()
        cfg = self.cfg = self.program_cfg()
        self.images = self._targets(model)
        # the frames are on the device already: served by index in the loop's
        # thread (no frame cache to copy them into, no decode to overlap)
        cfg.data_device_cache, cfg.dataloader_workers = False, 0
        self.views = _Views(self.w2cs, self.K, self.images, mix["max_steps"])
        if dev.type == "cpu":
            cfg.refine_every = CPU_PERIOD
        self.period = cfg.refine_every
        graphs.reset_loop_counts()
        self.i, self.failed, self.log = 0, 0, []
        mu0 = {k: getattr(adam.mu, k).clone() for k in LEAVES}
        p0 = {k: getattr(model.params, k)[:sc["gaussians"]].clone() for k in LEAVES}
        random.seed(self.seed)  # train()'s shuffle draws from Python's random
        start = trainer.TrainLoopState(model=model, adam=adam,
                                       active_sh_degree=mix["sh_degree"],
                                       step=mix["start_step"])
        self.run = trainer.iter_train(cfg, self.views, device=dev, start=start)
        self._check_steps(mu0, p0)
        self.snap = [t.clone() for t in graphs.state_leaves(self.loop.model, self.loop.adam)]
        self.snap_step = self.loop.step
        self._warm()

    def _targets(self, model) -> torch.Tensor:
        """Each view's target: ``target_blend`` of the seed's procedural
        image and the rest the port's render of the seeded state there."""
        b = float(self.mix["target_blend"])
        images = inputs.targets(self.scene, self.seed, self.device)
        if b == 1.0:
            return images
        from easy_gaussian_splatting_torch.models.render import CameraView
        from easy_gaussian_splatting_torch.ops.rasterize_tiled import make_isect_counter
        from easy_gaussian_splatting_torch.training.config import config_from_dict
        from easy_gaussian_splatting_torch.training.trainer import get_render_fn, tuned_binning

        cfg = config_from_dict(dict(self.recipe))
        counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles,
                                     ov_frac=cfg.ov_frac, small_budget=cfg.small_budget)
        with torch.no_grad():
            vals = torch.stack([counter(model.params, model.alive, w2c, self.K, height=self.h,
                                        width=self.w) for w2c in self.w2cs]).amax(0)
            cfg.isect_mult, cfg.small_budget, cfg.ov_frac = tuned_binning(
                cfg, vals.cpu().numpy(), model.capacity, 1.5)
            render_fn = get_render_fn(cfg)
            for v, w2c in enumerate(self.w2cs):
                out = render_fn(model.params, model.alive,
                                CameraView(w2c=w2c, K=self.K, width=self.w, height=self.h),
                                self.mix["sh_degree"], self.background, None)
                images[v] = b * images[v] + (1.0 - b) * out.image
        return images

    # ------------------------------------------------------------ the loop
    def _step(self) -> None:
        """One iteration of ``train()``; its failures counted and its
        event's counts logged."""
        from easy_gaussian_splatting_torch.training.graphs import loop_counts

        before = loop_counts()
        self.loop = next(self.run)
        d = {k: v - before[k] for k, v in loop_counts().items()}
        self.failed += d["isect_overflows"] + d["losses_nonfinite"] + int(
            d["event_overflows"] > 0 or d["capacity_changes"] > 0)
        self.log.append(dict(step=self.loop.step, capacity=self.loop.model.capacity,
                             num_splits=self.cfg.num_splits,
                             event=d if d["refine_events"] else None))
        self.i += 1

    def _check_steps(self, mu0, p0) -> None:
        """The first steps, through the loop: each loss, the first gradient
        as Adam took it, and the event's readings (each leaf's norm of the
        change of the parameters it read from the seeded ones ``p0``, the
        statistics it read, its counts, the state it left and what it
        changed), read around ``run_densify_with_growth``."""
        from easy_gaussian_splatting_torch.models.optimizer import BETA1

        seen, n = {}, self.scene["gaussians"]

        def read_event(loop, generator, event):
            m, st = loop.model, loop.model.stats
            rows = m.alive.clone()
            seen["stats"] = {k: _norm(getattr(st, f), rows) for k, f in zip(
                ref_densify.STATS, STAT_FIELDS)}
            pre = dict(zip(GROUPS, (
                {k: v.clone() for k, v in t.items()} for t in _trees(m, loop.adam))))
            seen["moved"] = {k: float(torch.linalg.norm((v[:n] - p0[k]).double()))
                             for k, v in pre["params"].items()}
            p0.clear()
            info = event()
            post = _trees(loop.model, loop.adam)
            alive = loop.model.alive
            seen.update(info=dict(info), alive=int(rows.sum()),
                        state=_state_norms(*post, alive), change=_state_norms(*post, alive, pre),
                        split=_split_offset(pre["params"], rows, post[0], alive))
            return info

        losses = []
        with _reading_events(read_event):
            for k in range(self.mix["check_steps"]):
                self._step()
                losses.append(float(self.loop.losses["total"]))
                if k == 0:
                    mu = self.loop.adam.mu
                    seen["grad"] = {
                        name: float(torch.linalg.norm(
                            (getattr(mu, name).double() - BETA1 * mu0[name].double())
                            / (1.0 - BETA1)))
                        for name in LEAVES}
                    mu0.clear()
        if "info" not in seen:
            raise RuntimeError(f"no refine event in steps {self.mix['start_step'] + 1}-"
                               f"{self.loop.step}: start_step + check_steps must be an event")
        self.prog = dict(losses=losses, **seen)
        self.failed = 0

    def _restore(self) -> None:
        """The snapshot into the loop's own tensors (a grown capacity's rows
        past it dead) and the loop's step back to the snapshot's."""
        from easy_gaussian_splatting_torch.training.graphs import state_leaves

        leaves = state_leaves(self.loop.model, self.loop.adam)
        for i, (dst, src) in enumerate(zip(leaves, self.snap)):
            if dst.dim() == 0 or dst.shape[0] == src.shape[0]:
                dst.copy_(src)
            else:
                dst[:src.shape[0]].copy_(src)
                dst[src.shape[0]:].zero_()
                if i == LEAVES.index("quats"):
                    dst[src.shape[0]:, 0] = 1.0
        self.loop.step = self.snap_step

    def _period(self) -> None:
        self._restore()
        for _ in range(self.period):
            self._step()

    def _warm(self) -> None:
        """Periods that serve each view once in order, then (on a CUDA
        device, where the loop captures) one in the loop's own shuffle that
        has to pass with no capture, binning rebuild or capacity change (else
        one more, ``WARM_PERIODS`` periods at the most). The first period's
        event is read for the comparison (``prog["period"]``, its inputs
        ``period_inputs``) and its counts kept (``warm_event``)."""
        from easy_gaussian_splatting_torch.training.graphs import loop_counts

        views = self.scene["views"]
        self.views.queue = list(range(views))
        self.warm_event, self.warm_periods = None, 0
        with _reading_events(self._read_period):
            self._period()
        self.warm_periods = 1
        self.warm_event = self.log[-1]["event"]
        while self.views.queue:
            self._period()
            self.warm_periods += 1
        while self.warm_periods < WARM_PERIODS and self.device.type == "cuda":
            before = loop_counts()
            cap0 = self.loop.model.capacity
            self._period()
            self.warm_periods += 1
            after = loop_counts()
            if (after["captures"] == before["captures"] and self.loop.model.capacity == cap0
                    and after["binning_changes"] == before["binning_changes"]):
                break
        self.failed = 0

    def _read_period(self, loop, generator, event):
        """The warm-up's first event: its inputs to the host (the
        parameters, alive flags and statistics over the capacity, and the
        split noise's generator state), then what it did."""
        m = loop.model
        pre = {k: getattr(m.params, k).clone() for k in LEAVES}
        rows = m.alive.clone()
        self.period_inputs = dict(
            params={k: v.cpu() for k, v in pre.items()}, alive=rows.cpu(),
            stats={k: getattr(m.stats, f).cpu() for k, f in zip(ref_densify.STATS, STAT_FIELDS)},
            generator=generator.get_state())
        info = event()
        post = {k: getattr(loop.model.params, k) for k in LEAVES}
        self.prog["period"] = dict(info=dict(info), alive=int(rows.sum()),
                                   **_event_readings(pre, rows, post, loop.model.alive))
        return info

    def describe(self) -> str:
        c, e = self.cfg, self.warm_event or {}
        return (f"capacity {self.loop.model.capacity}, {self.warm_periods} warm-up periods, "
                f"isect_mult {c.isect_mult}, small_budget {c.small_budget}, ov_frac {c.ov_frac}; "
                f"the warm-up's first event: split {e.get('split')}, clone {e.get('clone')}, "
                f"pruned {e.get('prune_low_opacity')} / {e.get('prune_large_radii')} / "
                f"{e.get('prune_large_scale')} (opacity / radius / scale) of "
                f"{self.prog['period']['alive']} alive; the check event: {self.prog['info']}")

    def window(self, seconds: float) -> dict:
        """Whole refine periods for ``seconds``, then one synchronize; then,
        outside the wall, steps up to ``LEAD`` before the next event, and
        the state there copied into the snapshot's tensors."""
        from easy_gaussian_splatting_torch.training.graphs import state_leaves

        dev = self.device
        start = self.i
        cells.sync(dev)
        with record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                self._period()
                if time.perf_counter() - t0 >= seconds:
                    break
            with record_function("bench.sync"):
                cells.sync(dev)
            wall = time.perf_counter() - t0
        n = self.i - start
        self._restore()
        for _ in range(self.period - self._lead() - 1):
            self._step()
        leaves = state_leaves(self.loop.model, self.loop.adam)
        if [t.shape for t in leaves] == [t.shape for t in self.snap]:
            for dst, src in zip(self.snap, leaves):
                dst.copy_(src)
        else:
            self.snap = [t.clone() for t in leaves]
        self.snap_step = self.loop.step
        return dict(units=n, wall_s=wall, train_views_per_s=n / wall)

    def _lead(self) -> int:
        return min(LEAD, self.mix["trace_units"] - 1)

    def traced_units(self, n: int) -> None:
        """``n`` steps for the profiler, the ``LEAD + 1``-th the event's. A
        window profiled again starts from the same state and statistics,
        kept in the snapshot at ``LEAD`` steps before the event."""
        if self.loop.step != self.snap_step:
            self._restore()
        for _ in range(n):
            with record_function("train.dispatch"):
                self._step()

    def unit_views(self, first: int, n: int) -> List[int]:
        return list(range(first, first + n))  # the iterations, which work_counts reads

    def work_counts(self, iterations: List[int]) -> List[dict]:
        """Each traced step's capacity and, for the event's, its counts
        (``graphs.loop_counts``' increments)."""
        return [dict(self.log[i]) for i in iterations]

    def captures(self) -> int:
        from easy_gaussian_splatting_torch.training.graphs import loop_counts

        return loop_counts()["captures"]

    def release(self) -> None:
        """Close the loop (it reads the pending losses and frees its
        graphs), then drop the state and the snapshot."""
        from easy_gaussian_splatting_torch.training.graphs import loop_counts

        if self.run is not None:
            before = loop_counts()
            self.run.close()
            after = loop_counts()
            self.failed += after["losses_nonfinite"] - before["losses_nonfinite"] + (
                after["isect_overflows"] - before["isect_overflows"])
        self.run = self.loop = self.snap = None

    # ---------------------------------------------------------- the check
    def reference(self, tf32: bool = False, loss_rows: int | None = None) -> dict:
        """The reference's readings of the check steps from the seed's
        inputs and the views the loop served, and of the warm-up's first
        event from the program's own inputs to it (float64; float32 with
        TF32 products for the control): the same numbers as the program's,
        and each leaf's norm of the change of the parameters the check
        event read from the seeded ones (``moved``)."""
        dev = self.device
        hi = torch.float32 if tf32 else torch.float64
        g = inputs.gaussians(self.scene, self.seed, dev)
        mu, nu = inputs.moments(self.scene, self.config["adam"], self.seed, dev)
        k = self.mix["check_steps"]
        views = [(self.w2cs[v], self.K, self.images[v]) for v in self.views.served[:k]]
        lrs = [inputs.learning_rates(self.recipe, self.mix["start_step"] + j + 1)
               for j in range(k)]
        def noise(cap: int) -> torch.Tensor:
            """The program's draw: train()'s generator, seeded from the
            recipe, on the device (the check event is its first)."""
            gen = torch.Generator(device=dev).manual_seed(self.recipe["random_seed"])
            return torch.randn((cap, 3), generator=gen, dtype=torch.float32, device=dev)

        r = ref_densify.follow(
            {k: v.to(hi) for k, v in g.items()}, {k: v.to(hi) for k, v in mu.items()},
            {k: v.to(hi) for k, v in nu.items()}, self.config["adam"]["steps"], views, lrs,
            self.scene["capacity"], self.cfg.max_capacity, noise, self.recipe, width=self.w,
            height=self.h, background=self.background, tf32=tf32, loss_rows=loss_rows)
        (pp, pm, pv, pre_alive), (qp, qm, qv, alive) = r["pre"], r["post"]
        n = self.scene["gaussians"]
        return dict(
            losses=r["losses"], alive=n,
            grad={k: float(torch.linalg.norm(r["first"][k].double())) for k in LEAVES},
            moved={k: float(torch.linalg.norm((pp[k][:n] - g[k].to(hi)).double()))
                   for k in LEAVES},
            stats={k: float(torch.linalg.norm(r["stats"][k].double())) for k in ref_densify.STATS},
            info=r["info"], state=_state_norms(qp, qm, qv, alive),
            change=_state_norms(qp, qm, qv, alive, dict(zip(GROUPS, (pp, pm, pv)))),
            split=_split_offset(pp, pre_alive, qp, alive),
            period=self._period_reference(hi))

    def _period_reference(self, hi) -> dict:
        """The reference's event on the program's inputs to the warm-up's
        first event (``period_inputs``), with the split noise the program
        drew there; an event that needs more slots than are free taken
        again at twice the capacity (at most ``max_capacity``), the new
        slots dead, as the port grows its state and retries with the same
        draw."""
        dev, e = self.device, self.period_inputs
        params = {k: v.to(dev, hi) for k, v in e["params"].items()}
        alive = e["alive"].to(dev)
        stats = {k: v.to(dev, hi) for k, v in e["stats"].items()}
        n0 = alive.shape[0]
        while True:
            gen = torch.Generator(device=dev)
            gen.set_state(e["generator"])
            cap = alive.shape[0]
            noise = torch.randn((cap, 3), generator=gen, dtype=torch.float32, device=dev)
            out, _, _, alive_out, info, overflow = ref_densify.densify_and_prune(
                params, {}, {}, alive, stats, noise.to(hi), self.recipe)
            if not overflow or cap >= self.cfg.max_capacity:
                break
            grow = min(2 * cap, self.cfg.max_capacity) - cap
            params = {k: torch.cat([v, torch.zeros((grow,) + v.shape[1:], dtype=v.dtype,
                                                   device=dev)]) for k, v in params.items()}
            params["quats"][cap:, 0] = 1.0
            alive = torch.cat([alive, torch.zeros(grow, dtype=alive.dtype, device=dev)])
            stats = {k: torch.cat([v, v.new_zeros(grow)]) for k, v in stats.items()}
        pre = {k: v[:n0] for k, v in params.items()}
        return dict(info=info, alive=int(alive.sum()),
                    **_event_readings(pre, alive[:n0], out, alive_out))

    def compare(self, ref: dict, got: dict | None = None) -> Dict[str, float]:
        """The numbers that decide ``correct``: the worst check step's
        relative loss gap; the worst leaf's first-gradient gap; the worst
        leaf's gap in the norm of the change of the parameters the check
        event read from the seeded ones (``change_gap``: a state the steps
        left unchanged reads 1; over the leaves whose reference gradient is
        more than a thousandth of the median leaf's, the others moving by
        round-off alone, as ``tandt_db.train`` reads it); the worst of
        the statistics' norms as the event read them; the largest gap of the
        event's counts over the alive Gaussians; the worst leaf's gap, within
        its group (parameters, first and second moments), in the norm of the
        state the event left over its alive slots (``event_gap``) and of the
        event's change to it there (``new_gap``: the new Gaussians and the
        moments it zeroed; also the norm of the split children's offsets from
        their parents, where either side split); and, for the warm-up's
        first event taken by both from the program's own inputs, the worst
        of its counts' gap over the alive, its change's leaf gap and its
        split children's offsets' gap (``period_event_gap``)."""
        got = got or self.prog
        med = float(np.median([ref["grad"][k] for k in LEAVES]))
        moving = [k for k in LEAVES if ref["grad"][k] > 1e-3 * med]
        gp, rp = got["period"], ref["period"]
        return {
            "loss_gap": max(cells.rel_gap(a, b, 0.0) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": cells.leaf_gaps(got["grad"], ref["grad"], LEAVES),
            "change_gap": cells.leaf_gaps(got["moved"], ref["moved"], moving),
            "stats_gap": max(cells.rel_gap(got["stats"][k], ref["stats"][k], 0.0)
                             for k in ref_densify.STATS),
            "event_count_gap": max(abs(got["info"][k] - ref["info"][k])
                                   for k in ref_densify.COUNTS) / ref["alive"],
            "event_gap": max(cells.leaf_gaps(got["state"][g], ref["state"][g], LEAVES)
                             for g in GROUPS),
            "new_gap": max([_change_gap(got["change"][g], ref["change"][g]) for g in GROUPS]
                           + [_split_gap(got["split"], ref["split"])]),
            "period_event_gap": max(
                max(abs(gp["info"][k] - rp["info"][k]) for k in ref_densify.COUNTS) / rp["alive"],
                _change_gap(gp["change"], rp["change"]), _split_gap(gp["split"], rp["split"])),
        }


def _split_gap(got: float, want: float) -> float:
    """The gap of the split children's offsets' norms; 0 where neither side
    split."""
    return cells.rel_gap(got, want, 0.0) if got or want else 0.0


def _change_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """``cells.leaf_gaps`` of one group's change norms; a group the event did
    not change in either reads 0."""
    if not any(want.values()) and not any(got.values()):
        return 0.0
    med = float(np.median([want[k] for k in LEAVES]))
    return max(cells.rel_gap(got[k], want[k], med) for k in LEAVES)
