"""The package's logger (``jcf_tpu/utils/logging.py``'s ``get_logger``):
a named logger with one stream handler on stdout and, optionally, a log
file, configured once per name."""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def get_logger(name: str = "jcf_tpu_torch", log_file: Optional[str] = None) -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
