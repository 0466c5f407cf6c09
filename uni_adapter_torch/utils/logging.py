"""Logging setup (mirror of `uni_adapter_tpu/utils/logging.py`, one
process: no host rank gate).

Root-logger stream and file handlers with the reference's
`%(asctime)s | %(levelname)s | %(message)s` format.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.INFO) -> None:
    """Log to stdout and, if given, `log_file`; handlers of an earlier
    setup are removed and closed (per-corruption runs set up anew)."""
    logger = logging.getLogger()
    logger.setLevel(level)
    formatter = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                                  datefmt="%Y-%m-%d,%H:%M:%S")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(formatter)
        logger.addHandler(h)
