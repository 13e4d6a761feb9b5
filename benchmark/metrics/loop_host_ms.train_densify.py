"""Host milliseconds a traced step in ``train()``'s own loop outside the
train step and the refine event: the ``train.loop.*`` spans (the
program's: the data, the dispatch, the loss readback, checkpoint, eval,
the reset, the SH bump, the log) less ``train.loop.densify`` and less the
``train.step`` spans nested in them (the graphed step's call), summed and
divided by the traced steps (layer: entry)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    loop = [(s, s + d) for name, s, d in w.spans
            if name.startswith("train.loop.") and name != "train.loop.densify"]
    if not loop:
        return None
    steps = [(s, s + d) for name, s, d in w.spans if name == "train.step"]
    nested = sum(b - a for a, b in steps if any(x <= a and b <= y for x, y in loop))
    return (sum(b - a for a, b in loop) - nested) / w.units * 1e3
