"""Device milliseconds per train step in kernels that are neither the
port's CUDA kernels nor matrix products (``torch.profiler``, by name)."""

from benchmark import yardstick


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    s = w.kernel_s(lambda n: yardstick.port_kernel(n) is None
                   and not yardstick.GEMM_PATTERN.search(n))
    return 1e3 * s / w.units if s > 0 else None
