"""Milliseconds the traced refine event holds ``train()``'s loop up
(``refine.critical_ms``): from the moment the device reaches the event,
the steps queued before it done, until the loop's ``train.loop.densify``
span ends (the event's program, the readback of its counts, the
watchdog's re-count and the capture ahead), over the events (layer:
entry)."""

from benchmark import refine


def read(ctx):
    w = ctx.window
    if w is None or not w.complete:
        return None
    return refine.critical_ms(w)
