"""Profiling; counterpart of ``easy_gaussian_splatting_tpu/utils/profiling.py``.

``Trace(logdir)`` records a ``torch.profiler`` window (host and, on the
card, device activity) between its ``start`` and ``stop`` and writes it as
a Chrome trace, ``logdir/trace.json`` (viewable in Perfetto or
``chrome://tracing``); ``trace(logdir)`` is the same window around a
``with`` block.

``span(name)`` is the port's one tracing helper: a context manager around
a piece of host work. While a ``torch.profiler`` window records, it enters
``record_function(name)``, so the span lands on the profiler's timeline
beside the device's records; while ``time_spans`` is on (``train()`` turns
it on for ``EGS_TORCH_LOOP_TIMING=1``), it adds its host-clock duration to
a total by name. Otherwise it costs one check and returns a shared null
context. Spans are named ``<owner>.<piece>``: ``train.*`` for the train
step and ``train()``'s loop, ``serve.*`` for the viewer's render,
``eval.*`` for the evaluator's programs.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time
from pathlib import Path
from typing import Dict

import torch
from torch.profiler import record_function

logger = logging.getLogger(__name__)

_profiling = torch._C._autograd._profiler_enabled  # true while a profiler window records
_NULL = contextlib.nullcontext()
_totals: Dict[str, float] | None = None  # host seconds by span name while time_spans is on


class _TimedSpan:
    """A span whose host-clock duration goes into the totals (and into the
    profiler's timeline too while one records)."""

    __slots__ = ("name", "traced", "t0")

    def __init__(self, name: str, traced):
        self.name, self.traced = name, traced

    def __enter__(self):
        if self.traced is not None:
            self.traced.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _totals is not None:
            _totals[self.name] += time.perf_counter() - self.t0
        if self.traced is not None:
            self.traced.__exit__(*exc)


def span(name: str):
    """A context manager around the host work it encloses: a
    ``record_function(name)`` while a profiler window records, timed into
    :func:`time_spans`'s totals while they are on, else a shared null
    context."""
    if _totals is not None:
        return _TimedSpan(name, record_function(name) if _profiling() else None)
    if _profiling():
        return record_function(name)
    return _NULL


def time_spans(on: bool) -> Dict[str, float] | None:
    """Turn the spans' host-clock totals on (a new, empty mapping of span
    name to seconds, returned) or off (None). The totals are the process's:
    one owner at a time (``train()`` while ``EGS_TORCH_LOOP_TIMING=1``)."""
    global _totals
    _totals = collections.defaultdict(float) if on else None
    return _totals


class Trace:
    """A ``torch.profiler`` window that writes ``trace.json`` into
    ``logdir`` when it stops (the trainer opens and closes it at given
    steps)."""

    def __init__(self, logdir: str | Path):
        from torch.profiler import ProfilerActivity, profile

        self.path = Path(logdir) / "trace.json"
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> Path:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        logger.info(f"profiler trace written to {self.path}")
        return self.path


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a profiler trace of the enclosed work into ``logdir``. Wrap
    a handful of training steps, not the whole run."""
    window = Trace(logdir)
    window.start()
    try:
        yield window
    finally:
        window.stop()
