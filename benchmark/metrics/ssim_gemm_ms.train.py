"""Device milliseconds per train step in matrix-product kernels (the SSIM
window's separable blur and its gradient; ``torch.profiler``, by name)."""

from benchmark import yardstick


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    s = w.kernel_s(lambda n: bool(yardstick.GEMM_PATTERN.search(n)))
    return 1e3 * s / w.units if s > 0 else None
