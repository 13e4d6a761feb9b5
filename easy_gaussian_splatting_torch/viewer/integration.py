"""Viewer <-> model integration; counterpart of
``easy_gaussian_splatting_tpu/viewer/integration.py``: load
``cameras.json``, build the render closure the viewer serves (a captured
CUDA graph per frame size on the card, eager on the CPU), and build the
training viewer (the closure over the loop's live state behind a
``DelayRender`` mailbox).

The training viewer renders ``loop.model`` in the loop's own thread
(``viewer.update_render_image()``, between steps): the model's tensors are
the graphed train step's buffers, updated in place by each step, which
the graphed render reads by reference (``donated``), and a frame rendered
between two steps reads them whole. The HTTP threads only post requests
to the mailbox.

A frame's spans (``utils/profiling.py::span``, recorded while a profiler
window runs): ``serve.render`` around the closure's call, re-renders
included, and inside it, graphed, ``serve.take`` (the model check),
``serve.copy_in`` and ``serve.replay`` (``graphs.Programs``),
``serve.wait`` (the copy to pinned memory enqueued, then the event
waited on) and ``serve.to_host`` (the image copied out of the pinned
buffer, the count read); eager, ``serve.to_host`` (the image and count
read back)."""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..utils.profiling import span
from .camera import CameraState
from .server import Viewer

logger = logging.getLogger(__name__)


def load_camera_states(path: Path) -> List[CameraState]:
    camera_states = []
    with open(Path(path) / "cameras.json", "r") as f:
        for cam in json.load(f):
            c2w = np.eye(4)
            c2w[:3, :3] = np.array(cam["rotation"])
            c2w[:3, 3] = np.array(cam["position"])
            w2c = np.linalg.inv(c2w)
            K = np.array(
                [
                    [cam["fx"], 0, cam["width"] / 2],
                    [0, cam["fy"], cam["height"] / 2],
                    [0, 0, 1],
                ],
                np.float32,
            )
            camera_states.append(CameraState(w2c, K, cam["width"], cam["height"]))
    return camera_states


def capacity_scale(pixels: int, base_pixels: int) -> float:
    """Intersection-capacity scale of a ``pixels``-sized frame against the
    probe frame the capacity was tuned at: intersection counts grow about
    linearly with pixels. Below the probe size it is the JAX viewer's
    scale (1.5x headroom over the linear estimate, capped at 1); above it,
    the linear scale itself, where the JAX viewer stays at 1 and truncates
    tiles. The caller clamps the result to the memory budget."""
    ratio = pixels / base_pixels
    return max(min(1.0, ratio * 1.5 + 0.05), ratio)


RENDER_GRAPHS = 8  # captured frame programs kept, as the JAX viewer's lru_cache(maxsize=8)


class GraphedRender:
    """The served render as CUDA graphs, the counterpart of the JAX viewer's
    ``_jitted`` (``jax.jit`` per frame size and SH degree, an LRU of 8):
    one captured render per ``(width, height, sh_degree, capacity,
    isect_mult)``, least recently used dropped past ``RENDER_GRAPHS``.

    Static inputs: each program's ``w2c`` and ``K`` buffers, the background
    and one set of model tensors (params and ``alive``) that every program
    reads; a model of another capacity drops the programs and gives a new
    set. By default the set is the render's own: a clone of the first model
    of a capacity, into which a model is copied unless it is the tensors
    copied last, at the same versions (the offline viewer's model never
    changes, so it is copied once). With ``donated`` the set is the first
    model's own tensors, taken by reference, and a model whose tensors are
    others is copied into it: the training viewer's (see
    :func:`construct_training_viewer`), whose model, graphed, is the train
    step's donated buffers, updated in place by each step with no version
    change, so they are read where they are and nothing is copied.

    After a replay the image is copied once into a pinned host buffer of
    its size, read after an event, and returned as an array of its own (the
    server may keep a frame past the next render). The programs are a
    ``graphs.Programs`` (one memory pool, one capture stream), each frame
    copied out before the next replay. Captures happen on a CUDA device
    only; another device raises."""

    def __init__(self, make_render_fn, background: torch.Tensor, donated: bool = False):
        from ..training.graphs import Programs

        self.programs = Programs(
            background.device, RENDER_GRAPHS, "the render",
            lambda k: f"{k[0]}x{k[1]}, sh {k[2]}, capacity {k[3]}, isect_mult {k[4]}",
            prefix="serve")
        self.device = self.programs.device
        self.make_render_fn = make_render_fn  # isect_mult -> render function
        self.background = background
        self.donated = donated
        self.model: List[torch.Tensor] | None = None
        self.source = None  # (data_ptr, version) of the tensors copied last
        self.captures = self.programs.captures
        self._host = {}  # (height, width) -> pinned image and count, and their event

    def _take(self, model: List[torch.Tensor]) -> None:
        """Make ``model``'s values the programs' model set."""
        from ..training.graphs import copy_in

        if self.model is None or self.model[0].shape != model[0].shape:
            self.programs.reset()
            self.model = model if self.donated else [t.detach().clone() for t in model]
            self.source = None
        source = [(t.data_ptr(), t._version) for t in model]
        if self.donated or source != self.source:
            copy_in(self.model, model)
            self.source = source

    def _frame(self, key, w2c, K):
        """The render of ``key`` over the model set: (image, count or None)."""
        from ..models.gaussians import PARAM_NAMES, GaussianParams
        from ..models.render import CameraView

        width, height, sh, _, mult = key
        params = GaussianParams(**dict(zip(PARAM_NAMES, self.model[:-1])))
        camera = CameraView(w2c=w2c, K=K, width=width, height=height)
        out = self.make_render_fn(mult)(params, self.model[-1], camera, sh, self.background)
        return out.image, out.num_isects

    def __call__(self, state, w2c, K, width: int, height: int, sh: int, mult):
        """(image [H, W, 3] f32 on the host, intersection count or None)."""
        from ..models.gaussians import PARAM_NAMES

        with span("serve.take"):
            self._take([getattr(state.params, n) for n in PARAM_NAMES] + [state.alive])
        key = (width, height, sh, state.capacity, mult)
        camera = [torch.as_tensor(np.asarray(x, np.float32)) for x in (w2c, K)]
        image, n = self.programs.run(key, lambda bufs: self._frame(key, *bufs), camera).out
        with span("serve.wait"):
            host = self._host.get((height, width))
            if host is None:
                host = self._host[(height, width)] = dict(
                    event=torch.cuda.Event(),
                    image=torch.empty((height, width, 3), dtype=torch.float32, pin_memory=True),
                    n=torch.empty((), dtype=torch.int32, pin_memory=True))
            host["image"].copy_(image, non_blocking=True)
            if n is not None:
                host["n"].copy_(n, non_blocking=True)
            host["event"].record()
            host["event"].synchronize()
        with span("serve.to_host"):
            return host["image"].numpy().copy(), None if n is None else int(host["n"])


def make_gs_render_func(get_state, get_sh_degree, background, render_fn,
                        cfg=None, base_pixels=None, donated: bool = False):
    """Render closure over model state; ``get_state`` / ``get_sh_degree``
    are callables so the latest state is picked up. On a CUDA device (the
    background's) each frame replays a captured render (:class:`GraphedRender`,
    exposed as the closure's ``graphed``, reading the model by reference
    when ``donated``); on the CPU it renders eagerly.

    With ``cfg`` + ``base_pixels`` (the offline viewer), the intersection
    capacity is sized per frame size: first by :func:`capacity_scale`,
    clamped to ``max_isect_cap``; a frame whose intersections exceed its
    capacity is rendered again with the capacity grown to 1.5x its count
    (within ``max_isect_cap``), which that frame size keeps (a new key of
    the graphed render). Intersection counts scale less than linearly at
    small sizes, where most Gaussians cover one tile. Each frame's count,
    capacity and re-render count land in the closure's ``stats``."""
    from ..models.render import CameraView
    from ..ops.rasterize_tiled import isect_capacity, max_isect_cap
    from ..training.trainer import get_render_fn

    tiled = cfg is not None and bool(base_pixels) and cfg.renderer == "tiled"
    mults = {}  # (width, height, capacity) -> isect_mult

    def make_render_fn(mult):
        return get_render_fn(dataclasses.replace(cfg, isect_mult=mult)) if tiled else render_fn

    cuda = background.device.type == "cuda"
    programs = GraphedRender(make_render_fn, background, donated) if cuda else None

    def frame(state, camera_state, width, height, sh, mult):
        """(host image, intersection count or None)."""
        if programs is not None:
            return programs(state, camera_state.w2c, camera_state.K, width, height, sh, mult)
        device = state.params.means.device
        camera = CameraView(
            w2c=torch.as_tensor(camera_state.w2c, dtype=torch.float32, device=device),
            K=torch.as_tensor(camera_state.K, dtype=torch.float32, device=device),
            width=width,
            height=height,
        )
        out = make_render_fn(mult)(state.params, state.alive, camera, sh, background)
        with span("serve.to_host"):
            n = None if out.num_isects is None else int(out.num_isects)
            return out.image.cpu().numpy(), n

    @torch.no_grad()
    def gs_render_func(camera_state: CameraState) -> np.ndarray:
        with span("serve.render"):
            return render(camera_state)

    def render(camera_state: CameraState) -> np.ndarray:
        state = get_state()
        sh = int(get_sh_degree())
        cap = getattr(camera_state, "sh_cap", None)
        if cap is not None:
            # interactive degradation: the client caps the SH degree while
            # the camera moves
            sh = min(sh, int(cap))
        width, height = int(camera_state.width), int(camera_state.height)
        if not tiled:
            return frame(state, camera_state, width, height, sh, None)[0]
        key = (width, height, state.capacity)
        max_mult = max_isect_cap(cfg.isect_hbm_budget_mb) / state.capacity
        if key not in mults:
            scale = capacity_scale(width * height, base_pixels)
            mults[key] = min(max(0.25, cfg.isect_mult * scale), max_mult)
        retries = 0
        while True:
            image, n = frame(state, camera_state, width, height, sh, mults[key])
            icap = isect_capacity(state.capacity, mults[key])
            grown = min(n * 1.5 / state.capacity, max_mult)
            if n <= icap or retries or grown <= mults[key]:
                break
            logger.warning(
                f"{width}x{height} frame: {n} intersections > capacity {icap}; "
                "rendering again with a larger capacity"
            )
            mults[key] = grown
            retries += 1
        if n > icap:
            logger.warning(f"{width}x{height} frame truncated: {n} > capacity {icap}")
        gs_render_func.stats = dict(
            width=width, height=height, num_isects=n, isect_cap=icap,
            rerenders=retries,
        )
        return image

    gs_render_func.stats = {}
    gs_render_func.graphed = programs
    return gs_render_func


def construct_training_viewer(loop, cfg, output_dir: Path, port: int = 9981) -> Viewer:
    """The viewer ``train()`` serves with ``view_online``: the render closure
    over ``loop``'s live model and SH degree, in training mode (requests go
    to the mailbox the loop renders from). Unlike the JAX package's, the
    closure sizes the intersection capacity per frame size from the live
    ``cfg`` and renders a frame again when it overflows, as the offline
    viewer does; ``port=0`` binds a free port (``Viewer.port``).

    On the card the graphed render reads the loop's model by reference
    (``donated``): graphed, that model is the train step's buffers, updated
    in place; eager, each step's state is new. Either way the loop's state
    only moves forward, so a newer state copied into the tensors the render
    took first overwrites nothing the loop still reads (graphed, the step
    copies the same values into its buffers at its next call)."""
    from ..training.trainer import get_render_fn

    camera_states = load_camera_states(output_dir)
    device = loop.model.alive.device
    background = torch.full(
        (3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32, device=device
    )
    base_px = (
        int(camera_states[0].width) * int(camera_states[0].height)
        if camera_states else None
    )
    render_func = make_gs_render_func(
        lambda: loop.model,
        lambda: loop.active_sh_degree,
        background,
        get_render_fn(cfg),
        cfg=cfg,
        base_pixels=base_px,
        donated=True,
    )
    return Viewer(
        render_func,
        camera_states,
        port=port,
        in_training_mode=True,
        video_output_dir=output_dir / "videos",
    )
