"""1 - (the union of the device's busy intervals / the traced window),
over a window of steady train steps, from its first device operation on
(``trace.Window.steady_s``)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete or w.busy_s <= 0:
        return None
    return 1.0 - w.busy_s / w.steady_s
