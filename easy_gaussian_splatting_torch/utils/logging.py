"""Console logging; counterpart of
``easy_gaussian_splatting_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import sys

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
