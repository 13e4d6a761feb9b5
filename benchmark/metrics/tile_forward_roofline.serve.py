"""``tiled_forward``'s share of its roofline in the served frame, in
percent: its least time on each traced frame's inputs
(``yardstick.forward_bound_s`` on the reference's counts) over its
profiled time per frame."""

from benchmark import yardstick


def read(ctx):
    w = ctx.window
    if w is None or not w.complete or not ctx.counts:
        return None
    t = w.kernel_s(lambda n: yardstick.port_kernel(n) == "tiled_forward") / w.units
    if t <= 0:
        return None
    bound = sum(yardstick.forward_bound_s(c) for c in ctx.counts) / len(ctx.counts)
    return 100.0 * bound / t
