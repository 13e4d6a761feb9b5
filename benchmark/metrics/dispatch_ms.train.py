"""Host milliseconds from calling the graphed train step until it returns,
the mean over every step of the measured window (the benchmark's own
span; layer: compiled programs)."""


def read(ctx):
    return ctx.measured.get("dispatch_ms")
