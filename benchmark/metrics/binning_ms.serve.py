"""Device milliseconds per served frame in binning: the ``binkeys`` kernel
and the sorts (the depth order and the key sort; every sort of the frame
is the binning's)."""

from benchmark import yardstick


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    s = w.kernel_s(lambda n: yardstick.port_kernel(n) == "binkeys"
                   or bool(yardstick.SORT_PATTERN.search(n)))
    return 1e3 * s / w.units if s > 0 else None
