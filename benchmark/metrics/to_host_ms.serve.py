"""Host milliseconds a traced frame in ``serve.to_host`` (the program's
span: the image copied out of the pinned buffer into the returned array,
and the intersection count read), summed over the traced window and
divided by its frames (layer: compiled programs)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    durs = [d for name, _, d in w.spans if name == "serve.to_host"]
    if not durs:
        return None
    return sum(durs) / w.units * 1e3
