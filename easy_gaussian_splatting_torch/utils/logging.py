"""Global state and console logging; counterpart of
``easy_gaussian_splatting_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import random
import sys

import numpy as np

_FORMAT = "%(asctime)s | %(levelname)-5s | %(message)s"
_DATEFMT = "%m%d-%H:%M:%S"
_configured = False


def configure_logging(level: int = logging.DEBUG) -> None:
    """Timestamped console logging on stdout, once per process."""
    global _configured
    if _configured:
        return
    root = logging.getLogger()
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root.addHandler(handler)
    root.setLevel(level)
    logging.getLogger("PIL").setLevel(logging.INFO)
    logging.getLogger("matplotlib").setLevel(logging.WARNING)
    _configured = True


def set_global_state(seed: int, device: str | None = None) -> None:
    """Seed Python's and numpy's global generators, then configure logging,
    as the JAX package's ``set_global_state`` does: the scene split, the
    Blender point cloud and the frame shuffle draw from these generators in
    the same order in both packages. ``device`` is accepted for config
    compatibility; the entry points take theirs from ``--device``."""
    random.seed(seed)
    np.random.seed(seed)
    configure_logging()


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
