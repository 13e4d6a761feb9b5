"""Profiling and step timing; counterpart of
``easy_gaussian_splatting_tpu/utils/profiling.py``.

``trace(logdir)`` records a ``torch.profiler`` window (host and, on the
card, device activity) and writes it as a Chrome trace under ``logdir``
(viewable in Perfetto or ``chrome://tracing``). ``StepTimer`` collects
step latencies and reports percentiles; steps whose tensors lie on the
card are timed with CUDA events, which read the device's own clock, and
CPU steps with the host clock.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


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


class StepTimer:
    """Collects per-step latencies and reports percentiles. ``device`` of
    type cuda times with CUDA events (read after a synchronize in
    ``summary``), anything else with the host clock."""

    def __init__(self, device: Optional[str | torch.device] = None) -> None:
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._durations: List[float] = []  # seconds, host clock
        self._events: List[tuple] = []  # (start, end) CUDA events
        self._t0: float | None = None
        self._start_event = None

    def start(self) -> None:
        if self._cuda:
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._cuda and self._start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._start_event, end))
            self._start_event = None
        elif self._t0 is not None:
            self._durations.append(time.perf_counter() - self._t0)
            self._t0 = None

    def durations_ms(self) -> List[float]:
        if self._events:
            self._events[-1][1].synchronize()
            self._durations += [s.elapsed_time(e) / 1e3 for s, e in self._events]
            self._events.clear()
        return [d * 1e3 for d in self._durations]

    def summary(self) -> Dict[str, float]:
        d = np.asarray(self.durations_ms())
        if not d.size:
            return {}
        return {
            "steps": float(len(d)),
            "mean_ms": float(d.mean()),
            "p50_ms": float(np.percentile(d, 50)),
            "p90_ms": float(np.percentile(d, 90)),
            "p99_ms": float(np.percentile(d, 99)),
            "it_per_s": float(1e3 / d.mean()),
        }

    def log_summary(self, prefix: str = "step timing") -> None:
        s = self.summary()
        if s:
            logger.info(
                f"{prefix}: mean={s['mean_ms']:.1f}ms p50={s['p50_ms']:.1f}ms "
                f"p90={s['p90_ms']:.1f}ms ({s['it_per_s']:.2f} it/s over {int(s['steps'])} steps)"
            )
