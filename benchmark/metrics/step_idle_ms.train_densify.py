"""``step_idle_ms.train``'s reading in ``train()``'s densify phase, over the
traced steps, the refine event's included."""

from benchmark import refine

read = refine.reader("step_idle_ms.train")
