"""Host milliseconds a traced step in which the graphed step's call runs
and the device runs nothing: each ``train.step`` span (the program's span
around ``GraphedTrainStep.__call__``) less the device's busy intervals
inside it, from the window's first device operation on (as
``trace.Window.steady_s`` counts), summed and divided by the traced steps
(layer: compiled programs)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete or w.busy_s <= 0:
        return None
    busy = w.intervals()
    first = busy[0][0]
    spans = [(max(s, first), min(s + d, w.end)) for name, s, d in w.spans
             if name == "train.step"]
    if not spans:
        return None
    idle = sum(b - a - sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
               for a, b in spans if b > a)
    return idle / w.units * 1e3
