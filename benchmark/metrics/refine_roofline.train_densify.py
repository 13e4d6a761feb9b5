"""The traced refine event's share of its roofline, in percent: its least
bytes (``refine.event_bytes``, from the program's counts of the event:
``graphs.loop_counts``' increments over its step) over the HBM bandwidth
(``yardstick.PEAK_BYTES_PER_S``), over its program's device time
(``refine.event_ms``, the noise included)."""

from benchmark import refine, yardstick


def read(ctx):
    w = ctx.window
    events = [c for c in ctx.counts or [] if c.get("event")]
    if w is None or not w.complete or not events:
        return None
    ms = refine.event_ms(w)
    if not ms:
        return None
    least = sum(refine.event_bytes(c) for c in events) / len(events) / yardstick.PEAK_BYTES_PER_S
    return 100.0 * least / (ms * 1e-3)
