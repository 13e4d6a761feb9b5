"""``ssim_gemm_ms.train``'s reading in ``train()``'s densify phase: per traced
step, with the refine event's own device operations left out
(``refine.steps_only``)."""

from benchmark import refine

read = refine.on_steps("ssim_gemm_ms.train")
