"""The compiled step: the train step captured as a CUDA graph, one per static
signature; counterpart of ``easy_gaussian_splatting_tpu/training/
precompile.py`` and of the JAX trainer's ``jax.jit`` with
``donate_argnames=("model", "adam")``.

``step_signature`` is the key a program is built for (the JAX package's
precompile key, plus the renderer and the backward reduction and binning
in force). ``GraphedTrainStep`` has the call signature of
``make_train_step``'s closure and runs it as a replayed graph:

- it owns static input buffers: the model and Adam state, the frame
  (``w2c``, ``K``, ``image``, ``mask``) and the 0-d ``lr_means`` and three
  flags, which the step applies with ``torch.where`` (one program serves
  every step of a signature, as JAX traces its flags);
- the state passed at the first call is donated: its tensors become the
  buffers (cloned only where one is not a contiguous tensor of its own),
  and the captured program writes the new parameters, statistics and Adam
  state straight into them (the step's ``in_place``), so the step reads
  and writes one set of buffers, updated in place at every call, with no
  second copy of the state;
- each call copies a passed tensor into its buffer unless it is that
  buffer already (``data_ptr``), so state changed outside the graph
  (densify, opacity reset, a resumed checkpoint) is written back through
  the same buffers; it fills the scalars, replays and returns the buffers'
  state and the loss dict, which belongs to the graph: read or copy it
  before the next call;
- the programs of one state (one per frame size and SH degree, as
  ``jax.jit`` keeps one per shape) are kept in an LRU of ``TRAIN_GRAPHS``
  over the same state buffers and one memory pool, so a scene whose frames
  come in several sizes captures each size once. Sharing the pool is safe
  because the programs replay one at a time on one stream and each call's
  loss dict is read before the next. A state of another capacity resets
  every program and the pool before its first capture. A capture runs
  ``WARMUP_CALLS`` eager calls on the step's capture stream first (the
  kernels' first build, library workspaces; the same in-place step with
  every update skipped, which writes each buffer with its own bits), then
  records on that stream (one for all the programs of the pool) with
  ``capture_error_mode="thread_local"`` (the prefetch threads and the
  viewer's HTTP threads keep running) and logs its wall time and the
  growth of the pool. It happens in the call, at the first step of a
  signature: no thread captures ahead, as the JAX package's precompiler
  compiles ahead (a capture costs a few step times, not a compile).

The kernel wrappers count their launches in Python, which a replay does
not run: ``Captured`` records the counters' increments during the capture
(where nothing launches), takes them back, and adds them at every replay,
so a replayed step counts its launches as an eager step does (the warm-up
calls are real launches and count). ``chip_smoke.py`` holds these counts
to the kernels the profiler sees in replayed steps.

A graph runs only on a CUDA device: on any other, ``GraphedTrainStep``
raises, and ``train()`` on the CPU runs ``make_train_step`` eagerly.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence

import torch

from ..models.gaussians import PARAM_NAMES, DensifyStats, GaussianModelState, GaussianParams
from ..models.optimizer import AdamState
from .config import Config

logger = logging.getLogger(__name__)

WARMUP_CALLS = 2  # eager calls on the capture's stream before it records
TRAIN_GRAPHS = 4  # step programs kept for one state (frame sizes, SH degrees), least recent dropped
_STATS = tuple(f.name for f in dataclasses.fields(DensifyStats))


def step_signature(cfg: Config, capacity: int, height: int, width: int, sh_degree: int) -> tuple:
    """The static key of a train-step program: ``precompile.py``'s (capacity,
    H, W, SH degree, ``isect_mult``, ``ov_frac``, ``small_budget``,
    ``tile_size``, ``max_tiles``), then the renderer and the backward
    reduction and binning grid in force (module switches of
    ``ops/rasterize_tiled.py``). The learning rate and the flags are inputs
    of the program, not part of its key."""
    from ..ops import rasterize_tiled

    return (
        capacity, height, width, sh_degree, cfg.isect_mult, cfg.ov_frac, cfg.small_budget,
        cfg.tile_size, cfg.max_tiles, cfg.renderer, rasterize_tiled.BWD_REDUCE,
        rasterize_tiled.BINNING_IMPL,
    )


# ----------------------------------------------------------- launch counts
def _counters():
    from ..ops.kernels import binkeys, group_reduce, segments, tile_raster

    return (
        (binkeys, "launches"), (tile_raster, "launches"), (tile_raster, "backward_launches"),
        (segments, "launches"), (segments, "compact_launches"), (segments, "expand_launches"),
        (group_reduce, "launches"),
    )


def launch_counts() -> tuple:
    """Every kernel wrapper's launch counter, in a fixed order."""
    return tuple(getattr(mod, name) for mod, name in _counters())


def _add_counts(delta: Sequence[int]) -> None:
    for (mod, name), d in zip(_counters(), delta):
        setattr(mod, name, getattr(mod, name) + d)


def require_cuda(what: str, device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"{what} captures a CUDA graph and runs on a CUDA device only, not {device} "
            "(on the CPU the eager function is the one to call)"
        )
    return device


class Captured:
    """One captured program: ``fn``'s outputs from its capture (``out``) and
    the kernel launches recorded into it. ``WARMUP_CALLS`` eager calls of
    ``warmup`` (default ``fn``: the same work, leaving the state as it was)
    run on a side stream first (``stream``, or a new one), then the capture
    records on that stream. Programs that share a memory pool share their
    stream too: the allocator gives a freed block again only to work on the
    stream that freed it, so a capture on another stream would grow the
    pool past the blocks an earlier capture left free."""

    def __init__(self, fn: Callable, device, pool=None, warmup: Callable | None = None,
                 what: str = "program", stream: torch.cuda.Stream | None = None):
        device = require_cuda(what, device)
        stream = stream or torch.cuda.Stream(device)
        ambient = torch.cuda.current_stream(device)
        stream.wait_stream(ambient)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_CALLS):
                (warmup or fn)()
        ambient.wait_stream(stream)
        torch.cuda.synchronize(device)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        # the warm-up's cached blocks belong to the side stream: back to the
        # card (entering the capture empties the cache again; here, so that
        # the reserved bytes before and after it differ by the pool alone)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_counts([-d for d in self.launches])  # recorded, not launched
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches)

    def reset(self) -> None:
        self.graph.reset()
        self.out = None


# --------------------------------------------------------------- the step
def state_leaves(model: GaussianModelState, adam: AdamState) -> List[torch.Tensor]:
    """Model and Adam state as one flat list, in a fixed order."""
    return (
        [getattr(model.params, n) for n in PARAM_NAMES] + [model.alive]
        + [getattr(model.stats, n) for n in _STATS]
        + [getattr(adam.mu, n) for n in PARAM_NAMES] + [getattr(adam.nu, n) for n in PARAM_NAMES]
        + [adam.steps[n] for n in PARAM_NAMES]
    )


def state_from(leaves: Sequence[torch.Tensor]):
    """Inverse of :func:`state_leaves`: fresh containers over the tensors."""
    k = len(PARAM_NAMES)
    params = GaussianParams(**dict(zip(PARAM_NAMES, leaves[:k])))
    stats = DensifyStats(**dict(zip(_STATS, leaves[k + 1:k + 1 + len(_STATS)])))
    rest = leaves[k + 1 + len(_STATS):]
    adam = AdamState(
        mu=GaussianParams(**dict(zip(PARAM_NAMES, rest[:k]))),
        nu=GaussianParams(**dict(zip(PARAM_NAMES, rest[k:2 * k]))),
        steps=dict(zip(PARAM_NAMES, rest[2 * k:])),
    )
    return GaussianModelState(params=params, alive=leaves[k], stats=stats), adam


def copy_in(bufs: Sequence[torch.Tensor], values: Sequence[torch.Tensor]) -> None:
    """Each value into its buffer, unless it is that buffer already."""
    for buf, v in zip(bufs, values):
        if v.data_ptr() != buf.data_ptr():
            buf.copy_(v)


def _donated(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The donated state as buffers: each tensor itself, or a clone where it
    is not contiguous, needs a gradient or shares its memory with another."""
    seen, out = set(), []
    for t in leaves:
        if not t.is_contiguous() or t.requires_grad or t.data_ptr() in seen:
            t = t.detach().clone(memory_format=torch.contiguous_format)
        seen.add(t.data_ptr())
        out.append(t)
    return out


class GraphedTrainStep:
    """``make_train_step(cfg, render_fn)`` run as a CUDA graph per signature;
    see the module docstring. ``captures`` lists each capture's signature,
    warm-up and capture wall times (ms) and pool size (bytes)."""

    def __init__(self, cfg: Config, render_fn: Callable, device):
        from .trainer import make_train_step

        self.device = require_cuda("GraphedTrainStep", device)
        self.cfg = cfg
        self._step = make_train_step(cfg, render_fn)
        self.signature = None  # the last replayed program's
        self.captures: List[Dict] = []
        self._programs: OrderedDict = OrderedDict()  # signature -> (Captured, frame buffers)
        self._state = self._pool = None
        self._stream = torch.cuda.Stream(self.device)  # every capture's, as they share a pool
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._flags = [torch.zeros((), dtype=torch.bool, device=self.device) for _ in range(3)]

    @property
    def program(self) -> Captured | None:
        """The program of the last call."""
        entry = self._programs.get(self.signature)
        return None if entry is None else entry[0]

    def reset(self) -> None:
        """Drop the graphs, their pool and the buffers they hold."""
        if self._state is not None:
            for program, _ in self._programs.values():
                program.reset()
            self._programs.clear()
            self._state = self._pool = self.signature = None
            torch.cuda.empty_cache()  # the old pool's memory goes back to the card

    def _capture(self, sig, frame, kw):
        frame_bufs = [t.detach().clone(memory_format=torch.contiguous_format) for t in frame]

        def step(flags):
            m, a = state_from(self._state)
            model_new, adam_new, ld = self._step(m, a, *frame_bufs, self._lr, *flags, **kw,
                                                 in_place=True)
            # a no-op where the step wrote into the buffers, as it does
            copy_in(self._state, state_leaves(model_new, adam_new))
            return ld

        # the warm-up calls run the same in-place step with every group's
        # update skipped and no statistics taken: each buffer is written
        # with its own bits, so the state stays as it was given, and the
        # warm-up needs no more memory than the program
        skip_every = [torch.tensor(v, device=self.device) for v in (False, True, True)]
        while len(self._programs) >= TRAIN_GRAPHS:
            self._programs.popitem(last=False)[1][0].reset()
        p = Captured(lambda: step(self._flags), self.device, pool=self._pool,
                     warmup=lambda: step(skip_every), what="GraphedTrainStep",
                     stream=self._stream)
        self._programs[sig] = (p, frame_bufs)
        self.captures.append(dict(signature=sig, warmup_ms=p.warmup_ms,
                                  capture_ms=p.capture_ms, pool_bytes=p.pool_bytes))
        logger.info(
            f"captured the train step (capacity {sig[0]}, {sig[2]}x{sig[1]}, sh {sig[3]}, "
            f"isect_mult {sig[4]}) in {p.capture_ms:.1f} ms after {WARMUP_CALLS} warm-up "
            f"calls in {p.warmup_ms:.1f} ms; pool {p.pool_bytes / 2**20:.1f} MiB"
        )
        return self._programs[sig]

    def __call__(self, model: GaussianModelState, adam: AdamState, w2c, K, image, mask,
                 lr_means, do_stats, skip_all, skip_opac, *, height: int, width: int,
                 sh_degree: int):
        frame = (w2c, K, image, mask)
        for buf, v in zip([self._lr] + self._flags, (lr_means, do_stats, skip_all, skip_opac)):
            if isinstance(v, torch.Tensor):
                buf.copy_(v)
            else:
                buf.fill_(v)
        if self._state is not None and self._state[0].shape[0] != model.capacity:
            self.reset()  # another state: its programs go with the old one
        if self._state is None:
            self._state = _donated(state_leaves(model, adam))
            self._pool = torch.cuda.graph_pool_handle()
        else:
            copy_in(self._state, state_leaves(model, adam))
        sig = step_signature(self.cfg, model.capacity, height, width, sh_degree)
        entry = self._programs.get(sig)
        if entry is None:
            entry = self._capture(sig, frame, dict(height=height, width=width, sh_degree=sh_degree))
        else:
            self._programs.move_to_end(sig)
            copy_in(entry[1], frame)
        entry[0].replay()
        self.signature = sig
        model_new, adam_new = state_from(self._state)
        return model_new, adam_new, dict(entry[0].out)
