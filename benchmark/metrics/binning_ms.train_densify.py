"""``binning_ms.serve``'s reading in ``train()``'s densify phase: device
milliseconds per traced step in the ``binkeys`` kernel and the sorts, with
the refine event's own device operations left out
(``refine.steps_only``)."""

from benchmark import refine

read = refine.on_steps("binning_ms.serve")
