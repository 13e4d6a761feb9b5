"""Device milliseconds of the traced refine event's own operations
(``refine.event_ms``: inside the program's ``train.refine.event`` span,
from the split noise's draw on: the noise, the graph's kernels and the
counts' copy out), over the events (layer: train step)."""

from benchmark import refine


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    return refine.event_ms(w)
