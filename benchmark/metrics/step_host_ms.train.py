"""Host milliseconds a traced step of the graphed step's own work: the
``train.step`` spans (the program's span around
``GraphedTrainStep.__call__``) less the ``train.replay`` spans nested in
them (the graph's launch, in which the host waits while the device's queue
is full), summed and divided by the traced steps: the host's own cost of
a step (layer: compiled programs)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    steps = [(s, s + d) for name, s, d in w.spans if name == "train.step"]
    if not steps:
        return None
    replays = [(s, s + d) for name, s, d in w.spans if name == "train.replay"]
    nested = sum(b - a for a, b in replays if any(x <= a and b <= y for x, y in steps))
    return (sum(b - a for a, b in steps) - nested) / w.units * 1e3
