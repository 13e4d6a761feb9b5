"""TensorBoard reporting with the reference's typed dispatch; counterpart
of ``easy_gaussian_splatting_tpu/utils/tb.py``: dict -> add_scalars,
number -> add_scalar, ndarray -> add_image (HWC), through
``torch.utils.tensorboard``, imported only when a writer is made."""

from __future__ import annotations

import logging
import time
from typing import Any, Dict

import numpy as np

logger = logging.getLogger(__name__)


def tb_report(tb_writer, step: int, tb_info: Dict[str, Any]) -> None:
    for key, value in tb_info.items():
        if isinstance(value, dict):
            tb_writer.add_scalars(key, value, step, walltime=time.time())
        elif isinstance(value, (int, float)):
            tb_writer.add_scalar(key, value, step, walltime=time.time())
        elif isinstance(value, np.ndarray):
            tb_writer.add_image(key, value, step, walltime=time.time(), dataformats="HWC")
        else:
            logger.warning(
                f"unsupported type for tensorboard report: {type(value)} (key={key})"
            )


def create_tb_writer(logdir):
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(logdir)
