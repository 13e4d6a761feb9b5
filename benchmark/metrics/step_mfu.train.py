"""The train step's share of the card's peak, in percent: its least time
(the larger of its bytes over the HBM bandwidth and its operations over
the f32 peak, ``yardstick.step_bytes`` and ``yardstick.step_ops`` on the
traced steps' own views: the alive Gaussians and the live intersection
rows, no padding) over the traced window's wall time per step, from
its first device operation on (``trace.Window.steady_s``)."""

from benchmark import yardstick


def read(ctx):
    w = ctx.window
    if w is None or not w.complete or not ctx.counts:
        return None
    least = sum(yardstick.bound_s(c["step_bytes"], c["step_ops"]) for c in ctx.counts)
    return 100.0 * (least / len(ctx.counts)) / (w.steady_s / w.units)
