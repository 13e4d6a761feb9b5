"""Evaluator: render the eval split, average PSNR/SSIM/LPIPS, measure FPS
and latency; counterpart of
``easy_gaussian_splatting_tpu/evaluation/evaluator.py``.

Each eval frame is rendered, mask-composited as the loss does (``render =
mask * gt + (1 - mask) * render``) and scored; ``eval_render_num`` frames
drawn with Python's ``random`` are kept as GT|render side-by-side images.
Keys, as the JAX evaluator's: ``psnr``, ``ssim``, ``lpips`` or
``lpips_proxy``, ``render_<k>``, ``fps`` (frames dispatched back to back,
one synchronisation at the end), ``latency_ms`` (median of three blocking
single frames on the host clock, each the whole frame, render to SSIM,
and its PSNR read back) and ``latency_device_ms`` (one render's device
time: the replay of a chain of renders captured in a CUDA graph,
between two CUDA events, where the JAX package differences two on-device
loop lengths to cancel a remote link's fixed cost; the host clock on the
CPU).

On the card the frame is a compiled program, as the JAX evaluator jits
it: one CUDA graph per ``(height, width, sh_degree, capacity)`` (render,
``composite_mask``, ``psnr``, ``ssim`` and the frame's intersection
count), and LPIPS one per image size, all in one ``graphs.Programs`` (one
pool, one capture stream, ``EVAL_GRAPHS`` of each kind), replayed through
``Programs.run``. Each frame's camera, image and mask are copied into the
program's buffers, and its outputs out of them before the next replay (the scalars, the composite for LPIPS, the
kept render, the count). The frame program reads its model by reference
(``Programs.run``'s ``live``). By default the model is a set of the
evaluator's own: a clone of the model, into which each ``evaluate``
copies the model it is given (the ``eval`` command). Given ``programs``
(``train()``'s: the graphed step's, over its pool) the evaluator keeps no
copy: the programs join those and read the model each ``evaluate`` is
given where it is (the step's buffers, updated in place by every step; a
model at other addresses is captured again). The frame's capture and its warm-up replay happen before the FPS
window opens; ``latency_ms`` times a blocking replay (the JAX evaluator
times its jitted frame). A render function with a ``record`` method
(``eval.CountingRender``) is handed each replayed frame's count, the only
place it can come from: a replay runs no Python. On the CPU the same
operations run eagerly.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..models.loss import composite_mask
from ..models.render import CameraView
from .lpips import get_lpips
from .metrics import psnr, ssim

logger = logging.getLogger(__name__)

LATENCY_CHAIN = 6  # renders between the two events of latency_device_ms
EVAL_GRAPHS = 4  # frame and LPIPS programs kept, least recent dropped
_FRAME = ("w2c", "K", "image", "mask")


def _describe(key: tuple) -> str:
    """A program's key in its capture's log line."""
    if key[0] == "frame":
        return f"frame, {key[2]}x{key[1]}, sh {key[3]}, capacity {key[4]}"
    return f"LPIPS, {key[2]}x{key[1]}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Evaluator:
    def __init__(self, eval_render_num: int, render_fn: Callable, programs=None):
        self.eval_render_num = eval_render_num
        self.render_fn = render_fn
        self.lpips = get_lpips()  # "vgg" (pretrained) or "proxy" (seeded)
        # graphs.Programs: given (shared, the model read by reference), or
        # made at the first evaluate on the card (a model set of its own)
        self._programs = programs
        self._shared = programs is not None
        self._model = None  # the own programs' model set: params in PARAM_NAMES order, then alive

    def invalidate(self, render_fn: Callable | None = None) -> None:
        """Swap in the trainer's rebuilt render function (after a capacity
        autotune or growth); the programs captured over the old one go."""
        if render_fn is not None:
            self.render_fn = render_fn
        if self._shared:
            self._programs.drop(("frame", "lpips"))
        elif self._programs is not None:
            self._programs.reset()

    def _programs_on(self, device: torch.device):
        """The programs on ``device``: a ``graphs.Programs`` on the card,
        None (eager) elsewhere."""
        if device.type != "cuda":
            return None
        if self._programs is None:
            from ..training.graphs import Programs

            self._programs = Programs(device, EVAL_GRAPHS, "the eval's program", _describe)
        return self._programs

    def _render_out(self, model, data, sh_degree, background):
        camera = CameraView(w2c=data["w2c"], K=data["K"], width=data["width"],
                            height=data["height"])
        return self.render_fn(model.params, model.alive, camera, sh_degree, background, None)

    def _render(self, model, data, sh_degree, background) -> torch.Tensor:
        return self._render_out(model, data, sh_degree, background).image

    def _frame(self, model, data, sh_degree, background):
        """One eval frame: (render, composite, psnr, ssim, intersection count
        or None)."""
        out = self._render_out(model, data, sh_degree, background)
        comp = composite_mask(out.image, data["image"], data["mask"])
        return out.image, comp, psnr(comp, data["image"]), ssim(data["image"], comp), out.num_isects

    def _take(self, model):
        """The frame programs' model set: ``model``'s params and alive (by
        reference with shared programs; else copied into the evaluator's
        own set, a new one, and no programs, for another capacity)."""
        from ..models.gaussians import PARAM_NAMES
        from ..training.graphs import copy_in

        leaves = [getattr(model.params, n) for n in PARAM_NAMES] + [model.alive]
        if self._shared:
            return leaves
        if self._model is None or self._model[0].shape != leaves[0].shape:
            self._programs.reset()
            self._model = [t.detach().clone() for t in leaves]
        copy_in(self._model, leaves)
        return self._model

    def _frame_program(self, model_set, data, sh_degree, background):
        """The captured frame of ``data``'s size over ``model_set`` (taken by
        reference), replayed on ``data``'s camera, image and mask (and
        ``background``)."""
        from types import SimpleNamespace

        from ..models.gaussians import PARAM_NAMES, GaussianParams

        width, height = data["width"], data["height"]
        n = len(_FRAME) + 1

        def frame(bufs):
            model = SimpleNamespace(params=GaussianParams(**dict(zip(PARAM_NAMES, bufs[n:-1]))),
                                    alive=bufs[-1])
            return self._frame(model, dict(zip(_FRAME, bufs), width=width, height=height),
                               sh_degree, bufs[n - 1])

        key = ("frame", height, width, sh_degree, model_set[-1].shape[0])
        return self._programs.run(key, frame, [data[k] for k in _FRAME] + [background],
                                  live=model_set)

    def _lpips(self, comp: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """LPIPS of a pair: eager, or on the card the replay of the program
        of its image size (the result copied out)."""
        programs = self._programs_on(comp.device)
        if programs is None:
            return self.lpips.device_fn(comp, gt)
        key = ("lpips",) + tuple(comp.shape)
        return programs.run(key, lambda bufs: self.lpips.device_fn(*bufs), (comp, gt)).out.clone()

    @torch.no_grad()
    def evaluate(
        self,
        scene,
        split: str,
        model,
        sh_degree: int,
        background: torch.Tensor,
        num_workers: int = 3,
        cache=None,
    ) -> Dict[str, Any]:
        from ..scene.scene import prefetch_frames

        device = background.device
        programs = self._programs_on(device)
        record = getattr(self.render_fn, "record", None)
        n = scene.nbr_data(split)
        lpips_key = "lpips" if self.lpips.kind == "vgg" else "lpips_proxy"
        metrics: Dict[str, Any] = {"psnr": 0.0, "ssim": 0.0, lpips_key: 0.0}
        render_indexes = list(range(n))
        if len(render_indexes) > self.eval_render_num:
            render_indexes = random.sample(render_indexes, k=self.eval_render_num)
        psnrs, ssims, lpips_pairs, renders = [], [], [], []
        t0 = None
        last = None
        model_set = None if programs is None else self._take(model)
        if cache is not None:  # device-resident split: no copies inside the FPS window
            frames_iter = (cache.get(i) for i in range(n))
        else:
            frames_iter = prefetch_frames(scene, split, num_workers=num_workers)
        for i, data in enumerate(frames_iter):
            data = dict(data)
            for k in _FRAME:
                data[k] = torch.as_tensor(data[k], dtype=torch.float32, device=device)
            if programs is None:
                if i == 0:  # warm-up outside the FPS window
                    self._render(model, data, sh_degree, background)
                    _sync(device)
                    t0 = time.perf_counter()
                img, comp, m_psnr, m_ssim, _ = self._frame(model, data, sh_degree, background)
            else:
                if i == 0:  # capture and warm-up replay outside the FPS window
                    self._frame_program(model_set, data, sh_degree, background)
                    _sync(device)
                    t0 = time.perf_counter()
                program = self._frame_program(model_set, data, sh_degree, background)
                img, comp, m_psnr, m_ssim, count = program.out
                comp, m_psnr, m_ssim = comp.clone(), m_psnr.clone(), m_ssim.clone()
                if i in render_indexes:
                    img = img.clone()
                if record is not None and count is not None:
                    record(count.clone())
            psnrs.append(m_psnr)
            ssims.append(m_ssim)
            lpips_pairs.append((comp, data["image"]))
            if i in render_indexes:
                renders.append((data["image"], img))
            last = data

        if psnrs:
            vals = torch.stack(psnrs + ssims).cpu().numpy()  # the one synchronisation
            cost = time.perf_counter() - t0
            metrics["psnr"] = float(vals[: len(psnrs)].sum())
            metrics["ssim"] = float(vals[len(psnrs):].sum())
        else:
            cost = 0.0
        # LPIPS after the timed window (a separate VGG pass, not render time)
        if lpips_pairs:
            metrics[lpips_key] = float(torch.stack(
                [self._lpips(c, gt) for c, gt in lpips_pairs]).sum())
        for render_count, (gt, img) in enumerate(renders, start=1):
            metrics[f"render_{render_count}"] = np.concatenate(
                [gt.cpu().numpy(), img.cpu().numpy()], axis=1)
        for k in ("psnr", "ssim", lpips_key):
            metrics[k] /= max(n, 1)
        metrics["fps"] = n / cost if cost > 0 else 0.0
        if last is not None:
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                # the whole frame and its PSNR read back, as the JAX
                # evaluator times its jitted frame: its program on the card
                if programs is None:
                    self._frame(model, last, sh_degree, background)[2].cpu()
                else:
                    self._frame_program(model_set, last, sh_degree, background).out[2].cpu()
                times.append(time.perf_counter() - t1)
            metrics["latency_ms"] = float(np.median(times) * 1e3)
            metrics["latency_device_ms"] = self._chain_ms(model, last, sh_degree, background)
        return metrics

    def _chain_ms(self, model, data, sh_degree, background) -> float:
        """One render's time in a chain of ``LATENCY_CHAIN`` renders. On the
        card the chain is captured once (``graphs.Captured``, so the launch
        counters count each replay's renders) and one replay is timed with
        CUDA events, so the host's issue gaps between the render's launches
        are not counted; on the CPU, the host clock over the chain."""
        device = background.device
        if device.type == "cuda":
            from ..training.graphs import Captured

            def chain():
                for _ in range(LATENCY_CHAIN):
                    self._render(model, data, sh_degree, background)

            # no warm-up calls: the frame has just been rendered
            program = Captured(chain, device, warmup=lambda: None, what="the latency chain")
            program.replay()  # the first replay uploads the graph
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            program.replay()
            end.record()
            end.synchronize()
            program.reset()
            return float(start.elapsed_time(end) / LATENCY_CHAIN)
        t1 = time.perf_counter()
        for _ in range(LATENCY_CHAIN):
            self._render(model, data, sh_degree, background)
        return float((time.perf_counter() - t1) * 1e3 / LATENCY_CHAIN)
