"""The capture ahead of need; counterpart of
``easy_gaussian_splatting_tpu/training/precompile.py``.

A capacity growth or an SH-degree bump gives the graphed train step a new
signature, whose program is otherwise captured at its first step (a few
step times: warm-up calls, then the capture). Both events are predictable
(the capacity doubles when the population nears it, the SH degree bumps on
a fixed schedule), so ``train()`` captures the next program ahead, at the
points where the JAX trainer queues its background compile
(:func:`growth_targets` after a densify event, :func:`sh_bump_due`), with
the same dedup key. ``StepPrecompiler.warm`` calls
``GraphedTrainStep.prepare``:

- at the state's capacity (an SH bump) the program is captured over the
  state's buffers, its warm-up calls (the in-place step with every update
  skipped, which writes each buffer with its own bits) run between two
  steps;
- at the next capacity it is captured over the buffers of a copy of the
  state grown to it, allocated at the warm and held (about 720 B a slot:
  parameters, Adam moments, statistics) until the growth writes into them
  (``GraphedTrainStep.grown``) and the step adopts them with their
  program, or until an event no longer names that capacity
  (:meth:`StepPrecompiler.settle`), which frees them. The JAX package holds
  nothing ahead: its compile needs shapes only. So ``train()`` warms a
  growth the rule names only once it is near (:func:`growth_near`: the
  next event is expected to grow), not from 0.55 of the capacity on, which
  can be thousands of steps before the growth, or never.

Unlike JAX's compile worker, the capture runs on the loop's thread: its
warm-up calls execute on the buffers they are given (the live state, at an
SH bump), a capture records into the pool the step's replays use, the
launch counters are module integers a concurrent replay would also move,
and the capture's Python holds the interpreter the loop needs. So the
capture ahead moves the stall from the event's first step to the warm; it
does not hide it. A warm that fails is logged and training goes on (the
step then captures at its first use), as JAX's ``_compile`` does.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Sequence, Set, Tuple

import torch

from .config import Config
from .graphs import require_cuda

logger = logging.getLogger(__name__)


def growth_targets(cfg: Config, nbr_gaussians: int, capacity: int,
                   active_sh_degree: int) -> List[Tuple[int, int]]:
    """The (capacity, SH degree) signatures to warm after a densify event
    (the JAX trainer's rule): the next doubling once the population passes
    0.55 of the capacity (the growth comes at 0.85), with the next SH degree
    too when a bump may land before it (an interval at most two refine
    intervals)."""
    if not (nbr_gaussians > 0.55 * capacity and capacity < cfg.max_capacity):
        return []
    next_cap = min(capacity * 2, cfg.max_capacity)
    degrees = {active_sh_degree}
    if (cfg.sh_degree_interval != 0 and active_sh_degree < cfg.sh_degree
            and cfg.sh_degree_interval <= 2 * cfg.refine_every):
        degrees.add(active_sh_degree + 1)
    return [(next_cap, d) for d in sorted(degrees)]


GROW_AT = 0.85  # the population share of the capacity past which an event grows it (trainer)


def growth_near(nbr_before: int, nbr_gaussians: int, capacity: int) -> bool:
    """Whether the next densify event is expected to grow ``capacity``: the
    population after this event (``nbr_gaussians``), grown again by this
    event's net gain over ``nbr_before`` (the population after the event
    before, or at the start), passes ``GROW_AT`` of the capacity."""
    return nbr_gaussians + max(0, nbr_gaussians - nbr_before) > GROW_AT * capacity


def sh_bump_due(cfg: Config, step: int, active_sh_degree: int) -> bool:
    """Whether to warm the next SH degree at the state's capacity after
    ``step`` (the JAX trainer's rule: ``max(1, interval - 60)`` steps into
    each interval, below the config's degree)."""
    interval = cfg.sh_degree_interval
    return (interval != 0 and active_sh_degree < cfg.sh_degree
            and step % interval == max(1, interval - 60))


class StepPrecompiler:
    """Captures ahead for one graphed step (``graphs.GraphedTrainStep``)
    with a dedup set of warmed signatures; ``warmed`` records each capture
    ahead (its key, wall ms, bytes held for a grown state), ``failures``
    each failed one. On a device other than a CUDA one it raises, as the
    graphed step does."""

    def __init__(self, step):
        require_cuda("StepPrecompiler", step.device)
        self._step = step
        self._done: Set[tuple] = set()
        self.warmed: List[Dict] = []
        self.failures: List[Dict] = []

    def warm(self, cfg: Config, model, adam, height: int, width: int, sh_degree: int,
             capacity: int, frame: Sequence[torch.Tensor]):
        """Capture now the train step at ``capacity``, this frame size and
        SH degree (other statics from ``cfg`` now), over ``frame`` (``w2c``,
        ``K``, ``image``, ``mask``: the current step's). Returns True when
        it captured, False when it failed (logged), None when this
        signature was warmed already."""
        key = (
            capacity, height, width, sh_degree, cfg.isect_mult,
            cfg.ov_frac, cfg.small_budget, cfg.tile_size, cfg.max_tiles,
        )
        if key in self._done:
            return None
        self._done.add(key)
        t0 = time.perf_counter()
        try:
            captured = self._step.prepare(model, adam, *frame, height=height, width=width,
                                          sh_degree=sh_degree, capacity=capacity)
        except Exception as e:  # never break training from the warmer
            self.failures.append(dict(key=key, error=repr(e)))
            logger.warning(f"capture ahead (capacity {capacity}, sh {sh_degree}) failed: {e}")
            return False
        ms = (time.perf_counter() - t0) * 1e3
        held = self._step.prepared().get(capacity, 0)
        self.warmed.append(dict(key=key, ms=ms, held_bytes=held, captured=captured))
        logger.info(
            f"captured the train step ahead for capacity {capacity}, sh {sh_degree} in "
            f"{ms:.1f} ms" + (f"; {held / 2**20:.0f} MiB held for the grown state" if held else ""))
        return True

    def settle(self, capacities: Set[int]) -> None:
        """Free the states prepared for capacities outside ``capacities``
        (an event decided against that growth); their signatures may be
        warmed again."""
        for cap in list(self._step.prepared()):
            if cap not in capacities and self._step.release(cap):
                self._done = {k for k in self._done if k[0] != cap}
                logger.info(f"released the state prepared for capacity {cap}")

    def shutdown(self) -> None:
        """Free every state prepared ahead."""
        self.settle(set())
