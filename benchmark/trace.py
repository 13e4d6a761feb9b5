"""The traced window: ``torch.profiler`` over a few steps or frames, its
Chrome trace read back into device records, the device's busy time and
idle share, and ``breakdown``.

A window counts only when the port's kernels it holds equal the
increments of the program's launch counters over it
(``training/graphs.py::launch_counts``): the profiler loses runs of device
records in a few windows in a hundred, so a window that disagrees is
profiled again, ``WINDOWS`` times at the most.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

from . import yardstick

WINDOWS = 3
COUNTER_ORDER = ("binkeys", "tiled_forward", "tiled_backward", "segsum_band",
                 "segsum_compact", "monotone_expand", "group_reduce")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Window:
    """One profiled window: its device records [(name, start_s, dur_s,
    category)], host spans [(name, start_s, dur_s)] (the benchmark's), its
    bounds and ``units`` (steps or frames)."""

    def __init__(self, device: List[Tuple[str, float, float, str]],
                 spans: List[Tuple[str, float, float]], start: float, end: float, units: int,
                 complete: bool):
        self.device, self.spans = device, spans
        self.start, self.end, self.units, self.complete = start, end, units, complete

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def intervals(self) -> List[Tuple[float, float]]:
        """Device-busy intervals inside the window, merged."""
        iv = sorted((max(s, self.start), min(s + d, self.end)) for _, s, d, _ in self.device)
        merged: List[List[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals())

    @property
    def steady_s(self) -> float:
        """The window from its first device operation on: the host's first
        call into an idle queue, which the profiler's start makes and a
        running loop never has, left out."""
        iv = self.intervals()
        return self.end - (iv[0][0] if iv else self.start)

    def kernel_s(self, pick: Callable[[str], bool]) -> float:
        """Device seconds in kernels whose name ``pick`` accepts."""
        return sum(d for name, _, d, cat in self.device if cat == "kernel" and pick(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the benchmark span the host was in at each one's middle."""
        by_name: Dict[str, float] = {}
        for name, _, d, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.start
        for a, b in self.intervals() + [(self.end, self.end)]:
            if a > prev:
                gaps.append((self._span_at(0.5 * (prev + a)), a - prev))
            prev = max(prev, b)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}

    def _span_at(self, t: float) -> str:
        best = None
        for name, s, d in self.spans:
            if name != "bench.window" and s <= t < s + d and (best is None or d < best[1]):
                best = (name, d)
        return best[0] if best else "host outside the benchmark's spans"


def _read(path: str, units: int) -> Window:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        rec = (e.get("name", ""), float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            device.append(rec + (e["cat"],))
        elif e.get("cat") == "user_annotation" and rec[0].startswith(("bench.", "train.",
                                                                      "serve.")):
            spans.append(rec)
    win = [s for s in spans if s[0] == "bench.window"]
    if not win:
        raise RuntimeError("the profiler's trace holds no bench.window span")
    start, dur = win[0][1], win[0][2]
    return Window(device, spans, start, start + dur, units, True)


def port_launches(window: Window) -> Dict[str, int]:
    seen = dict.fromkeys(COUNTER_ORDER, 0)
    for name, _, _, cat in window.device:
        k = yardstick.port_kernel(name) if cat == "kernel" else None
        if k is not None:
            seen[k] += 1
    return seen


def profile(run_units: Callable[[int], None], units: int, counters: Callable[[], tuple],
            device) -> Window:
    """``run_units(units)`` under the profiler inside a ``bench.window``
    span ending in a synchronize, until a window's port kernels equal the
    launch counters' increments (at most ``WINDOWS`` windows; the last one
    is kept, ``complete`` False when none agreed)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        cuda = torch.device(device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda _: None)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for attempt in range(WINDOWS):
            sync(device)
            before = counters()
            with torch_profile(activities=activities) as prof:
                with torch.profiler.record_function("bench.window"):
                    run_units(units)
                    sync(device)
            counted = dict(zip(COUNTER_ORDER, (a - b for a, b in zip(counters(), before))))
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            win = _read(path, units)
            os.remove(path)
            seen = port_launches(win)
            if seen == counted:
                return win
            print(f"bench: traced window {attempt + 1}: the profiler saw {seen}, the launch "
                  f"counters rose by {counted}; profiling again", flush=True)
        win.complete = False
        return win
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
