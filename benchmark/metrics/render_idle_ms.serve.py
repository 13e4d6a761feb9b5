"""Host milliseconds a traced frame in which the program renders and the
device runs nothing: each ``serve.render`` span (the viewer's closure,
re-renders included; the program's span) less the device's busy intervals
inside it, summed over the traced window and divided by its frames
(layer: entry)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete or w.busy_s <= 0:
        return None
    spans = [(max(s, w.start), min(s + d, w.end)) for name, s, d in w.spans
             if name == "serve.render"]
    if not spans:
        return None
    busy = w.intervals()
    idle = sum(b - a - sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
               for a, b in spans if b > a)
    return idle / w.units * 1e3
