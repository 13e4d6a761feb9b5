"""What the refine event's per-layer metrics share: the event's device
operations in a traced window, its cost on the loop's critical path and
its least bytes."""

from __future__ import annotations

import copy
import importlib.util
import re
from pathlib import Path
from typing import List, Tuple

from .trace import Window

NOISE = re.compile(r"normal|distribution_elementwise", re.IGNORECASE)
DECIDE_READ = 3 * 4 + 1 + 4 + 3 * 4  # statistics, alive, opacity, scales: a slot's decision
STATS_WRITE = 3 * 4  # the statistics zeroed
ROW = 59 * 4  # a Gaussian's parameters
NEW_WRITE = 3 * ROW + 1  # a new Gaussian's parameters, its zeroed moments and alive flag
PRUNED_WRITE = 1  # a removed Gaussian's alive flag


def events(window) -> List[Tuple[float, List[tuple]]]:
    """Each refine event of ``window`` (a ``trace.Window``): the moment the
    device reached it and its device operations (the window's records).
    Inside a ``train.refine.event`` span the device first finishes the steps
    queued before it; the event's own operations start at its split noise's draw
    (the only normal-distribution kernel the loop launches) and run until
    the span ends: the noise, the graph's kernels, the counts' stack and
    their copy out. The device reaches the event at the end of its last
    operation before the noise, or at the span's start if it was idle
    then."""
    out = []
    for name, start, dur in window.spans:
        if name != "train.refine.event":
            continue
        ops = sorted((r for r in window.device if start <= r[1] < start + dur),
                     key=lambda r: r[1])
        first = next((i for i, (n, _, _, cat) in enumerate(ops)
                      if cat == "kernel" and NOISE.search(n)), None)
        if first is None:
            continue
        at = ops[first][1]
        reached = max([start] + [s + d for _, s, d, _ in window.device if s + d <= at])
        out.append((reached, ops[first:]))
    return out


def event_ms(window) -> float | None:
    """Device milliseconds of the event's own operations (:func:`events`),
    over the events of ``window``."""
    ms = [1e3 * sum(d for _, _, d, _ in ops) for _, ops in events(window)]
    return sum(ms) / len(ms) if ms else None


def critical_ms(window) -> float | None:
    """Milliseconds the event holds the loop up: from the moment the device
    reached it (:func:`events`) until the ``train.loop.densify`` span around
    it ends and the loop goes on to its next step (the program, the counts'
    readback, the watchdog's re-count and the capture ahead), over the
    events of ``window``. The queued steps the readback waits for are left
    out."""
    dens = [(s, s + d) for name, s, d in window.spans if name == "train.loop.densify"]
    ms = []
    for reached, ops in events(window):
        end = next((b for a, b in dens if a <= ops[0][1] <= b), None)
        if end is not None:
            ms.append(1e3 * (end - reached))
    return sum(ms) / len(ms) if ms else None


def event_bytes(c: dict) -> int:
    """The least bytes of one event (``c``: a traced step's capacity,
    ``num_splits`` and the event's counts): what each slot's decision reads
    (its statistics, alive flag, opacity and scales), the statistics zeroed
    over the capacity, each source Gaussian's parameters read (clone and
    split parents), each new Gaussian's parameters, zeroed moments and alive
    flag written, and each removed Gaussian's alive flag (split parents
    included)."""
    e = c["event"]
    new = e["clone"] + c["num_splits"] * e["split"]
    pruned = e["prune_low_opacity"] + e["prune_large_radii"] + e["prune_large_scale"] + e["split"]
    return (c["capacity"] * (DECIDE_READ + STATS_WRITE) + (e["clone"] + e["split"]) * ROW
            + new * NEW_WRITE + pruned * PRUNED_WRITE)


def steps_only(window):
    """``window`` with the refine events' own device operations
    (:func:`events`) left out: the train steps' alone."""
    own = {id(op) for _, ops in events(window) for op in ops}
    keep = [r for r in window.device if id(r) not in own]
    return Window(keep, window.spans, window.start, window.end, window.units, window.complete)


def reader(name: str):
    """The ``read(ctx)`` of the metric ``metrics/<name>.py``."""
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def on_steps(name: str):
    """The ``read(ctx)`` of the metric ``metrics/<name>.py``, reading the
    traced window with the refine events' own device operations left out
    (:func:`steps_only`)."""
    inner = reader(name)

    def read(ctx):
        if ctx.window is None:
            return None
        steps = copy.copy(ctx)
        steps.window = steps_only(ctx.window)
        return inner(steps)

    return read
