"""The compiled programs: the train steps, the programs over the train
state and the eval's frame captured as CUDA graphs, one per static
signature; counterpart of the JAX package's ``jax.jit`` programs (the
train steps with ``donate_argnames=("model", "adam")``, the sharded steps
of ``parallel/shard.py`` and ``parallel/gauss_shard.py``, the batched
step, the densify steps, ``reset_opacities`` with donation, the
intersection counters, the evaluator's frame); ``precompile.py`` captures
the step's next signatures ahead of need.

The machinery every program here shares:

- ``Captured``: one captured program. ``WARMUP_CALLS`` eager calls on the
  capture's stream first (the kernels' first build, library workspaces,
  the NCCL communicator's first collective), then the capture, with
  ``capture_error_mode="thread_local"`` (the prefetch threads, the
  viewer's HTTP threads and NCCL's own keep running); its wall times and
  the growth of its pool are recorded.
- ``Programs``: the captured programs of one owner over one memory pool
  and one capture stream, in an LRU for each kind of program.
  ``Programs.run`` is the one way an owner replays a program: at a key's
  first use it copies the inputs into buffers of the program's own and
  captures over them, afterwards it copies each call's inputs into those
  buffers; then it replays. Tensors passed as ``live`` are taken by
  reference instead: the program is captured over those very tensors
  (the train state's buffers), and other tensors at a later call make it
  capture again.
  Sharing the pool is safe because the programs replay one at a time on
  one stream and each replay's outputs are read or copied before the
  next; sharing the stream keeps the pool from growing by a copy a
  program (the allocator gives a freed block again only to work on the
  stream that freed it).
- The launch counters: the kernel wrappers count their launches in
  Python, which a replay does not run. ``Captured`` records the counters'
  increments during the capture (where nothing launches), takes them
  back and adds them at every replay, so a replayed program counts its
  launches as an eager call does (the warm-up calls are real launches and
  count); the collectives' ``CALLS`` likewise. ``chip_smoke.py`` holds
  the kernel counts to the kernels the profiler sees in replays.
- The spans (``utils/profiling.py::span``, recorded while a profiler window
  runs): each ``Programs`` takes a prefix from its owner (``train`` for
  ``GraphedTrainStep``, ``serve`` for the viewer's ``GraphedRender``,
  ``eval`` for the evaluator's programs) and records ``<prefix>.capture``
  around a capture, ``<prefix>.copy_in`` around the copy of a call's
  inputs into the program's buffers and ``<prefix>.replay`` around
  ``graph.replay()``; ``GraphedTrainStep`` records ``train.step`` around
  its whole call, whose self time is the host's own cost of a step.

``step_signature`` is the key the JAX package precompiles for (plus the
renderer and the backward reduction and binning in force);
``graph_signature`` adds what tells the step factories apart (the batch
size, the mesh). ``GraphedTrainStep(cfg, step, device, mesh=None)`` runs
an eager step as a replayed graph, with the step's call signature: the
single-camera step (``make_train_step``), the batched step
(``make_batched_train_step``: frames ``[B,4,4]``, ``[B,3,3]``,
``[B,H,W,3]``, ``[B,H,W]``) or the sharded step of an NCCL mesh
(``make_mesh_train_step`` with ``mesh``: this rank's shard of the state,
the padded frame):

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
- the programs of one state (one per frame size, SH degree and batch
  size, as ``jax.jit`` keeps one per shape) are kept in ``programs``
  (``TRAIN_GRAPHS`` of each kind), so a scene whose frames come in
  several sizes captures each size once. A state of another capacity
  drops every program and the pool before its first capture. The warm-up
  calls are the same in-place step with every update skipped, which
  writes each buffer with its own bits. A capture happens in the call, at
  the first step of a signature, unless ``prepare`` captured it ahead
  (``precompile.StepPrecompiler``, where the JAX trainer compiles ahead):
  at the state's capacity over its buffers, at the next capacity over the
  buffers of a grown copy of the state, which ``grown`` grows into and the
  step then adopts, their programs with them;
- the programs over the state (``replay``): ``train()``'s refine event,
  opacity reset, intersection counters and eval frame join the step's
  programs, in its pool, and take its buffers by reference (``own`` makes
  the step hold a state first, donating it as its first call would). A
  program that writes the state computes the new values first and writes
  them last, under a 0-d ``write`` flag (:func:`write_back`): its replays
  write, its warm-up calls, which execute on the live state, write each
  buffer with its own bits.

Under a mesh every rank captures at the same step and records the same
collectives in the same order: the signature holds only values that are
equal on every rank (the shard's capacity, the padded frame size, the SH
degree, the config and the mesh), and the step reads no device value on
the host. A gloo world cannot be captured (its collectives wait on the
host), so ``GraphedTrainStep`` refuses one and ``train()`` runs a gloo
mesh eagerly.

A graph runs only on a CUDA device: on any other, ``GraphedTrainStep``,
``Programs`` and ``Captured`` raise, and the CPU runs the eager
functions.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Sequence

import torch

from ..models.gaussians import (
    PARAM_NAMES,
    DensifyStats,
    GaussianModelState,
    GaussianParams,
    grow_capacity,
)
from ..models.optimizer import AdamState, grow_adam_state
from ..utils.profiling import span
from .config import Config

logger = logging.getLogger(__name__)

WARMUP_CALLS = 2  # eager calls on the capture's stream before it records
TRAIN_GRAPHS = 4  # programs of each kind kept for one state (step: frame sizes, SH degrees), least recent dropped
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


def graph_signature(cfg: Config, capacity: int, height: int, width: int, sh_degree: int, *,
                    batch: int = 0, mesh=None) -> tuple:
    """A ``GraphedTrainStep`` program's key: :func:`step_signature` (under a
    mesh at the shard's capacity and the padded height), then the batch size
    (0: the single-camera step) and the mesh (its axes and shape, the stripe
    partition and interleave; None: no mesh). Every field is the same on
    every rank of a mesh, so the ranks capture at the same steps."""
    where = None if mesh is None else (tuple(mesh.axis_names), tuple(mesh.shape),
                                       cfg.stripe_partition, cfg.stripe_interleave)
    return step_signature(cfg, capacity, height, width, sh_degree) + (batch, where)


# ----------------------------------------------------------- launch counts
def _counters():
    from ..ops.kernels import adam, binkeys, group_reduce, segments, sh_color, tile_raster

    # the seven main-path counters first, in the order readers zip them with
    # their kernels' names; later kernels after them
    return (
        (binkeys, "launches"), (tile_raster, "launches"), (tile_raster, "backward_launches"),
        (segments, "launches"), (segments, "compact_launches"), (segments, "expand_launches"),
        (group_reduce, "launches"), (sh_color, "launches"), (sh_color, "backward_launches"),
        (adam, "launches"),
    )


def launch_counts() -> tuple:
    """Every kernel wrapper's launch counter, in a fixed order."""
    return tuple(getattr(mod, name) for mod, name in _counters())


def _add_counts(delta: Sequence[int]) -> None:
    for (mod, name), d in zip(_counters(), delta):
        setattr(mod, name, getattr(mod, name) + d)


# ------------------------------------------------------------ loop counts
# train()'s loop counters: its refine events and what they did (the counts
# event_values already reads back, so counting waits on nothing), the
# events that overflowed their free slots and the events that changed the
# capacity; the intersection watchdog's overflowed steps and the binning's
# rebuilds of the step; the losses read back that were not finite; the
# programs captured (``Programs.prepare``, any owner's)
LOOP_KEYS = ("refine_events", "split", "clone", "prune_low_opacity", "prune_large_radii",
             "prune_large_scale", "event_overflows", "capacity_changes", "isect_overflows",
             "binning_changes", "losses_nonfinite", "captures")
_loop_counts = dict.fromkeys(LOOP_KEYS, 0)


def loop_counts() -> Dict[str, int]:
    """``train()``'s loop counters (``LOOP_KEYS``) since the last
    :func:`reset_loop_counts`; the process's, as the launch counters are."""
    return dict(_loop_counts)


def reset_loop_counts() -> None:
    for k in _loop_counts:
        _loop_counts[k] = 0


def count_loop(**deltas: int) -> None:
    """Add to the loop counters (keys of ``LOOP_KEYS``)."""
    for k, d in deltas.items():
        _loop_counts[k] += int(d)


def _collective_calls() -> collections.Counter:
    from ..parallel.collectives import CALLS

    return CALLS


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
    the kernel launches (and collectives) recorded into it. ``WARMUP_CALLS``
    eager calls of ``warmup`` (default ``fn``: the same work, leaving the
    state as it was) run on a side stream first (``stream``, or a new one),
    then the capture records on that stream into ``pool``. Each replay is a
    ``<prefix>.replay`` span (``prefix``: its owner's)."""

    def __init__(self, fn: Callable, device, pool=None, warmup: Callable | None = None,
                 what: str = "program", stream: torch.cuda.Stream | None = None,
                 prefix: str = "program"):
        device = require_cuda(what, device)
        self.replay_span = f"{prefix}.replay"
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
        before, calls = launch_counts(), collections.Counter(_collective_calls())
        t0 = time.perf_counter()
        # the captured graph is kept beside its executable until reset: the
        # profiler (CUPTI) maps a replayed executable's nodes back to the graph
        # they were captured in, and a profiled replay with that graph destroyed
        # at instantiation (CUDAGraph's default) can crash in cuGraphLaunch
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn()
        self.graph.instantiate()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_counts([-d for d in self.launches])  # recorded, not launched
        self.collectives = collections.Counter(_collective_calls())
        self.collectives.subtract(calls)
        _collective_calls().subtract(self.collectives)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        with span(self.replay_span):
            self.graph.replay()
        _add_counts(self.launches)
        _collective_calls().update(self.collectives)

    def reset(self) -> None:
        self.graph.reset()
        self.out = None


def _kind(key: Hashable):
    """A program key's kind: its first element when that is a string
    (``"densify"``, ``"reset"``, ``"isects"``, ``"frame"``, ``"lpips"``),
    else None (a train-step signature)."""
    return key[0] if isinstance(key, tuple) and key and isinstance(key[0], str) else None


def same_tensors(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    """Whether ``a`` and ``b`` are the same tensors, address by address."""
    return len(a) == len(b) and all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b))


class Programs:
    """The captured programs of one owner, by key, over one memory pool and
    one capture stream (see the module docstring), in an LRU of ``size``
    programs of each kind (:func:`_kind`). ``run`` replays the program of a
    key, capturing it at the key's first use, and ``prepare`` captures
    without replaying; ``entries`` maps a key to its ``Captured``;
    ``captures`` (``captures`` if given: a list shared with other
    ``Programs``) lists every capture (its key, warm-up and capture wall
    times in ms, the pool's growth in bytes, ``ahead`` for a capture made
    ahead of need), resets included; ``reset`` drops every program and the
    pool, whose memory goes back to the card. ``describe`` names a key in
    the capture's log line; ``prefix`` (the owner's: ``train``, ``serve``,
    ``eval``) names its spans.

    A program may take tensors by reference (``live``: the train state's
    buffers): it is captured over those very tensors, never copied, so a
    replay reads, or writes in place, whatever they hold. A call whose
    ``live`` tensors are others (another address) drops the program and
    captures it again over them."""

    def __init__(self, device, size: int, what: str, describe: Callable[[Hashable], str] = repr,
                 captures: List[Dict] | None = None, prefix: str = "program"):
        self.device = require_cuda(what, device)
        self.size, self.what, self.describe, self.prefix = size, what, describe, prefix
        self.stream = torch.cuda.Stream(self.device)  # every capture's, as they share the pool
        self.pool = None
        self.entries: OrderedDict = OrderedDict()
        self.captures: List[Dict] = [] if captures is None else captures

    def prepare(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor],
                warmup: Callable | None = None, live: Sequence[torch.Tensor] = (),
                ahead: bool = False) -> Captured:
        """The program of ``key``, captured now unless it is held over
        ``live``: its buffers (``Captured.inputs``) copies of ``inputs`` on
        the programs' device, ``fn(buffers + live)`` captured after the
        warm-up calls of ``warmup(buffers + live)`` (default ``fn``), the
        least recent program of its kind dropped past ``size``. Nothing is
        replayed; ``fresh`` on the result says whether it was captured now."""
        live = list(live)
        p = self.entries.get(key)
        if p is not None and not same_tensors(p.live, live):
            self._pop([key])  # captured over other tensors
            p = None
        if p is not None:
            self.entries.move_to_end(key)
            p.fresh = False
            return p
        kind = _kind(key)
        same = [k for k in self.entries if _kind(k) == kind]
        self._pop(same[:max(0, len(same) + 1 - self.size)])
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with span(f"{self.prefix}.capture"):
            bufs = [torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
                    for t in inputs]
            p = Captured(lambda: fn(bufs + live), self.device, pool=self.pool,
                         warmup=None if warmup is None else lambda: warmup(bufs + live),
                         what=self.what, stream=self.stream, prefix=self.prefix)
        p.inputs, p.live, p.fresh = bufs, live, True
        self.entries[key] = p
        self.captures.append(dict(key=key, warmup_ms=p.warmup_ms, capture_ms=p.capture_ms,
                                  pool_bytes=p.pool_bytes, ahead=ahead))
        count_loop(captures=1)
        logger.info(
            f"captured {self.what} ({self.describe(key)}){' ahead of need' if ahead else ''} in "
            f"{p.capture_ms:.1f} ms after {WARMUP_CALLS} warm-up calls in {p.warmup_ms:.1f} ms; "
            f"pool {p.pool_bytes / 2**20:.1f} MiB"
        )
        return p

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor],
            warmup: Callable | None = None, live: Sequence[torch.Tensor] = ()) -> Captured:
        """Replay the program of ``key`` with ``inputs`` in its buffers and
        return it (its outputs in ``out``: read or copy them before the next
        replay), capturing it first at the key's first use (:meth:`prepare`);
        a held program's buffers take each input first, unless it is that
        buffer."""
        p = self.prepare(key, fn, inputs, warmup, live)
        if not p.fresh:
            with span(f"{self.prefix}.copy_in"):
                copy_in(p.inputs, inputs)
        p.replay()
        return p

    def drop(self, kinds: Sequence) -> None:
        """Drop the programs of these kinds (the pool stays while others
        hold it)."""
        self._pop([k for k in self.entries if _kind(k) in kinds])

    def _pop(self, keys: Sequence) -> None:
        """Drop the programs of ``keys``. A pool left with no program of
        this owner is not captured into again: once no graph holds it, the
        allocator frees it, and reusing its handle would capture into a
        pool it has released."""
        for key in keys:
            self.entries.pop(key).reset()
        if keys and not self.entries:
            self.pool = None

    def adopt(self, other: "Programs") -> None:
        """Drop every program and the pool, and take ``other``'s programs,
        pool and capture stream instead (``other`` is left empty)."""
        self.reset()
        self.entries, self.pool, self.stream = other.entries, other.pool, other.stream
        other.entries, other.pool = OrderedDict(), None

    def reset(self) -> None:
        for program in self.entries.values():
            program.reset()
        self.entries.clear()
        if self.pool is not None:
            self.pool = None
            torch.cuda.empty_cache()  # the old pool's memory goes back to the card


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


def _describe(key: tuple) -> str:
    """A program key in a capture's log line: a train-step signature, or a
    program over the state (its kind, then the rest of its key)."""
    if _kind(key) is not None:
        return ", ".join(str(k) for k in key)
    kind = (f", batch {key[-2]}" if key[-2] else "") + (
        f", mesh {dict(zip(*key[-1][:2]))}" if key[-1] else "")
    return f"capacity {key[0]}, {key[2]}x{key[1]}, sh {key[3]}, isect_mult {key[4]}{kind}"


def grow_state(model: GaussianModelState, adam: AdamState, capacity: int, out=None):
    """``model`` and ``adam`` grown to ``capacity`` (new rows dead, zero,
    identity quats, zero moments), into ``out`` (a model and Adam state of
    that capacity) when given, else into new tensors."""
    m_out, a_out = (None, None) if out is None else out
    return (grow_capacity(model, capacity, out=m_out),
            grow_adam_state(adam, capacity - model.capacity, out=a_out))


class GraphedTrainStep:
    """``step``, an eager train step, run as a CUDA graph per signature (see
    the module docstring): ``make_train_step``'s, ``make_batched_train_step``'s
    (frames with a leading B axis; B goes into the signature) or, with
    ``mesh`` (an NCCL mesh), ``make_mesh_train_step``'s. The call signature
    is the step's; under a mesh ``height`` is the padded frame's.

    It owns the train state's buffers (``state``) and every program over
    them (``programs``): its own step programs and, through :meth:`replay`,
    the programs that read or write the state by reference (the refine
    event, the opacity reset, the intersection counter, and in ``train()``
    the eval's frame), all in one pool and one capture stream. A new
    capacity drops them all. :meth:`prepare` captures a step program ahead
    of need (``precompile.StepPrecompiler``), over the state's buffers or
    over the buffers of a grown state allocated for it, which
    :meth:`grown` grows into and the step adopts with their programs.
    ``captures`` lists each step capture's signature (``key``), warm-up and
    capture wall times (ms), pool size (bytes) and ``ahead``;
    ``programs.captures`` every capture of a program over the state."""

    def __init__(self, cfg: Config, step: Callable, device, *, mesh=None):
        if mesh is not None and mesh.backend != "nccl":
            raise ValueError(
                f"a {mesh.backend} world cannot be captured in a CUDA graph: its collectives "
                "wait on the host (NCCL's can be captured; train() runs a gloo mesh eagerly)"
            )
        self.device = require_cuda("GraphedTrainStep", device)
        self.cfg, self.mesh, self._step = cfg, mesh, step
        self.signature = None  # the last replayed program's
        self.programs = Programs(self.device, TRAIN_GRAPHS, "a program over the train state",
                                 _describe, prefix="train")
        self._state = None
        self._stale = False  # a retune's step awaits its first capture (:meth:`use`)
        self._next: Dict[int, tuple] = {}  # capacity -> (buffers, Programs) prepared ahead
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._flags = [torch.zeros((), dtype=torch.bool, device=self.device) for _ in range(3)]
        # the warm-up calls' flags: every group's update skipped, no
        # statistics taken, so each buffer is written with its own bits and
        # the state stays as it was given (and the warm-up needs no more
        # memory than the program)
        self._skip_every = [torch.tensor(v, device=self.device) for v in (False, True, True)]
        # a program's write flag over the state: its replays write, its
        # warm-up calls write each buffer with its own bits
        self._write = [torch.tensor(v, device=self.device) for v in (True, False)]

    @property
    def captures(self) -> List[Dict]:
        return [c for c in self.programs.captures if _kind(c["key"]) is None]

    @property
    def state(self) -> List[torch.Tensor] | None:
        """The state's buffers (:func:`state_leaves` order), or None."""
        return self._state

    @property
    def program(self) -> Captured | None:
        """The program of the last call."""
        return self.programs.entries.get(self.signature)

    def _drop_next(self, capacity: int | None = None) -> None:
        for cap in [c for c in self._next if capacity is None or c == capacity]:
            self._next.pop(cap)[1].reset()

    def reset(self) -> None:
        """Drop the graphs, their pool and the buffers they hold (those
        prepared ahead too)."""
        self._drop_next()
        self._stale = False
        if self._state is not None:
            self.programs.reset()
            self._state = self.signature = None

    def use(self, step: Callable) -> None:
        """Run ``step`` from now on (a binning retune rebuilt it): the
        prepared states go now, the programs and their pool before the next
        capture of the step (:meth:`_fresh`), the state's buffers stay. Until
        then the other programs (a refine event, a re-count in the same
        iteration) replay as captured, over the same buffers: so the new
        pool's first program is always the step's, whichever point of the
        iteration the retune came from, and the pool's size with it."""
        self._step = step
        self._drop_next()
        self._stale = True

    def _fresh(self) -> None:
        """Drop the programs and pool a retune left (:meth:`use`)."""
        if self._stale:
            self._stale = False
            self.programs.reset()

    def own(self, model: GaussianModelState, adam: AdamState):
        """Make this step's buffers hold ``model`` and ``adam`` (the first
        state of a capacity is donated: its tensors become the buffers, or,
        when they are the buffers prepared for that capacity, the step takes
        them with their programs; another state of the held capacity is
        copied in) and return fresh containers over the buffers."""
        leaves = state_leaves(model, adam)
        if self._state is not None and self._state[0].shape[0] != model.capacity:
            self.programs.reset()  # another state: its programs go with the old one
            self._state, self._stale = None, False
        if self._state is None:
            nxt = self._next.pop(model.capacity, None)
            self._drop_next()
            if nxt is not None and same_tensors(nxt[0], leaves):
                self._state = nxt[0]
                self.programs.adopt(nxt[1])
            else:
                if nxt is not None:
                    nxt[1].reset()
                self._state = _donated(leaves)
        copy_in(self._state, leaves)
        return state_from(self._state)

    def replay(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor] = ()) -> Captured:
        """Replay the program ``key`` over the state's buffers by reference
        (capturing it at its first use, into the step's pool; see
        :meth:`Programs.run`): ``fn(buffers, write)``, ``buffers`` the
        copies of ``inputs`` then the state's leaves (:func:`state_from`
        reads them), ``write`` a 0-d bool, true in the program and false in
        its warm-up calls, which run eagerly on the state: a program that
        writes the state writes through :func:`write_back` under it. Call
        :meth:`own` first."""
        write, keep = self._write
        return self.programs.run(key, lambda bufs: fn(bufs, write), inputs,
                                 warmup=lambda bufs: fn(bufs, keep), live=self._state)

    def grown(self, model: GaussianModelState, adam: AdamState, capacity: int):
        """``model`` and ``adam`` grown to ``capacity``: into the buffers
        prepared for it (:meth:`prepare`), which the next call then adopts
        with their programs, or into new tensors."""
        nxt = self._next.get(capacity)
        return grow_state(model, adam, capacity, None if nxt is None else state_from(nxt[0]))

    def release(self, capacity: int) -> bool:
        """Drop the buffers and programs prepared for ``capacity``; whether
        there were any."""
        held = capacity in self._next
        self._drop_next(capacity)
        return held

    def prepared(self) -> Dict[int, int]:
        """The capacities prepared ahead and the bytes their buffers hold."""
        return {c: sum(t.numel() * t.element_size() for t in bufs)
                for c, (bufs, _) in self._next.items()}

    def prepare(self, model: GaussianModelState, adam: AdamState, w2c, K, image, mask, *,
                height: int, width: int, sh_degree: int, capacity: int) -> bool:
        """Capture ahead of need, on the calling thread and without a
        replay, the step program of ``capacity``, this frame size and SH
        degree, the frame's tensors its buffers' first values. At the
        state's capacity it is captured over the state's buffers (its
        warm-up calls, the in-place step with every update skipped, write
        each buffer with its own bits); at another, over the buffers of a
        copy of the state grown to it, allocated here and held until the
        growth adopts them (:meth:`grown`) or :meth:`release`, its program
        in the state's pool. Returns False when the program is held
        already."""
        self._fresh()
        model, adam = self.own(model, adam)
        if capacity == model.capacity:
            state, programs = self._state, self.programs
        else:
            if capacity not in self._next:
                nxt = Programs(self.device, TRAIN_GRAPHS, self.programs.what, _describe,
                               captures=self.programs.captures, prefix="train")
                # into the state's pool, on its stream: the grown program
                # reuses the blocks the state's programs free after their
                # captures, and keeps the pool when it is adopted
                nxt.pool, nxt.stream = self.programs.pool, self.programs.stream
                self._next[capacity] = (state_leaves(*grow_state(model, adam, capacity)), nxt)
            state, programs = self._next[capacity]
        sig = graph_signature(self.cfg, capacity, height, width, sh_degree,
                              batch=w2c.shape[0] if w2c.dim() == 3 else 0, mesh=self.mesh)
        if sig in programs.entries:
            return False
        kw = dict(height=height, width=width, sh_degree=sh_degree)
        programs.prepare(sig, lambda frame: self._run(state, frame, self._flags, kw),
                         (w2c, K, image, mask),
                         warmup=lambda frame: self._run(state, frame, self._skip_every, kw),
                         ahead=True)
        return True

    def _run(self, state, frame, flags, kw):
        """The in-place step over the buffers ``state`` and ``frame``; the
        loss dict."""
        m, a = state_from(state)
        model_new, adam_new, ld = self._step(m, a, *frame, self._lr, *flags, **kw, in_place=True)
        # a no-op where the step wrote into the buffers, as it does
        copy_in(state, state_leaves(model_new, adam_new))
        return ld

    def __call__(self, model: GaussianModelState, adam: AdamState, w2c, K, image, mask,
                 lr_means, do_stats, skip_all, skip_opac, *, height: int, width: int,
                 sh_degree: int):
        with span("train.step"):
            for buf, v in zip([self._lr] + self._flags, (lr_means, do_stats, skip_all, skip_opac)):
                if isinstance(v, torch.Tensor):
                    buf.copy_(v)
                else:
                    buf.fill_(v)
            self._fresh()
            self.own(model, adam)
            state = self._state
            self.signature = graph_signature(
                self.cfg, model.capacity, height, width, sh_degree,
                batch=w2c.shape[0] if w2c.dim() == 3 else 0, mesh=self.mesh)
            kw = dict(height=height, width=width, sh_degree=sh_degree)
            program = self.programs.run(
                self.signature, lambda frame: self._run(state, frame, self._flags, kw),
                (w2c, K, image, mask),
                warmup=lambda frame: self._run(state, frame, self._skip_every, kw))
            model_new, adam_new = state_from(self._state)
            return model_new, adam_new, dict(program.out)


def write_back(write: torch.Tensor, olds: Sequence[torch.Tensor], news: Sequence[torch.Tensor],
               ) -> None:
    """Each new value into its old tensor where ``write`` (a 0-d bool) holds,
    else the old value again (the same bits): a program over the state
    writes the buffers last, after every read of them."""
    for old, new in zip(olds, news):
        torch.where(write, new, old, out=old)
