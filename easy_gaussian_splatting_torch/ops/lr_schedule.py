"""Learning-rate schedules; counterpart of
``easy_gaussian_splatting_tpu/ops/lr_schedule.py``: only the ``means`` LR
decays, exponentially (a lerp in log space) from ``lr_init`` to
``lr_final`` over ``max_steps``."""

from __future__ import annotations

import numpy as np


def log_lerp_schedule(lr_init: float, lr_final: float, max_steps: int):
    """Returns step -> lr (a Python float), lerping in log space."""
    log_init = float(np.log(lr_init))
    log_final = float(np.log(lr_final))

    def schedule(step) -> float:
        t = min(1.0, float(step) / float(max_steps))
        return float(np.exp(log_init * (1.0 - t) + log_final * t))

    return schedule
