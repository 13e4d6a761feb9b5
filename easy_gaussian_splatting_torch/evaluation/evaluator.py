"""Evaluator: render the eval split, average PSNR/SSIM/LPIPS, measure FPS
and latency; counterpart of
``easy_gaussian_splatting_tpu/evaluation/evaluator.py``.

Each eval frame is rendered, mask-composited as the loss does (``render =
mask * gt + (1 - mask) * render``) and scored; ``eval_render_num`` frames
drawn with Python's ``random`` are kept as GT|render side-by-side images.
Keys, as the JAX evaluator's: ``psnr``, ``ssim``, ``lpips`` or
``lpips_proxy``, ``render_<k>``, ``fps`` (frames dispatched back to back,
one synchronisation at the end), ``latency_ms`` (median of three blocking
single renders on the host clock) and ``latency_device_ms`` (one render's
device time: the replay of a chain of renders captured in a CUDA graph,
between two CUDA events, where the JAX package differences two on-device
loop lengths to cancel a remote link's fixed cost; the host clock on the
CPU).
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Evaluator:
    def __init__(self, eval_render_num: int, render_fn: Callable):
        self.eval_render_num = eval_render_num
        self.render_fn = render_fn
        self.lpips = get_lpips()  # "vgg" (pretrained) or "proxy" (seeded)

    def invalidate(self, render_fn: Callable | None = None) -> None:
        """Swap in the trainer's rebuilt render function (after a capacity
        autotune or growth)."""
        if render_fn is not None:
            self.render_fn = render_fn

    def _render(self, model, data, sh_degree, background) -> torch.Tensor:
        camera = CameraView(w2c=data["w2c"], K=data["K"], width=data["width"],
                            height=data["height"])
        return self.render_fn(model.params, model.alive, camera, sh_degree, background, None).image

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
        n = scene.nbr_data(split)
        lpips_key = "lpips" if self.lpips.kind == "vgg" else "lpips_proxy"
        metrics: Dict[str, Any] = {"psnr": 0.0, "ssim": 0.0, lpips_key: 0.0}
        render_indexes = list(range(n))
        if len(render_indexes) > self.eval_render_num:
            render_indexes = random.sample(render_indexes, k=self.eval_render_num)
        psnrs, ssims, lpips_pairs, renders = [], [], [], []
        t0 = None
        last = None
        if cache is not None:  # device-resident split: no copies inside the FPS window
            frames_iter = (cache.get(i) for i in range(n))
        else:
            frames_iter = prefetch_frames(scene, split, num_workers=num_workers)
        for i, data in enumerate(frames_iter):
            data = dict(data)
            for k in ("w2c", "K", "image", "mask"):
                data[k] = torch.as_tensor(data[k], dtype=torch.float32, device=device)
            if i == 0:  # warm-up outside the FPS window
                self._render(model, data, sh_degree, background)
                _sync(device)
                t0 = time.perf_counter()
            img = self._render(model, data, sh_degree, background)
            comp = composite_mask(img, data["image"], data["mask"])
            psnrs.append(psnr(comp, data["image"]))
            ssims.append(ssim(data["image"], comp))
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
                [self.lpips.device_fn(c, gt) for c, gt in lpips_pairs]).sum())
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
                self._render(model, last, sh_degree, background).cpu()
                times.append(time.perf_counter() - t1)
            metrics["latency_ms"] = float(np.median(times) * 1e3)
            metrics["latency_device_ms"] = self._chain_ms(model, last, sh_degree, background)
        return metrics

    def _chain_ms(self, model, data, sh_degree, background) -> float:
        """One render's time in a chain of ``LATENCY_CHAIN`` renders. On the
        card the chain is captured once in a CUDA graph and one replay is
        timed with CUDA events, so the host's issue gaps between the
        render's launches are not counted; on the CPU, the host clock over
        the chain."""
        device = background.device
        if device.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(LATENCY_CHAIN):
                    self._render(model, data, sh_degree, background)
            graph.replay()  # the first replay uploads the graph
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ms = float(start.elapsed_time(end) / LATENCY_CHAIN)
            graph.reset()
            return ms
        t1 = time.perf_counter()
        for _ in range(LATENCY_CHAIN):
            self._render(model, data, sh_degree, background)
        return float((time.perf_counter() - t1) * 1e3 / LATENCY_CHAIN)
