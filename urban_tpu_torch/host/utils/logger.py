"""Console/file logging (reference: khrylib/utils/logger.py:5-26)."""
from __future__ import annotations

import logging
import os


def create_logger(filename: str, file_handle: bool = True) -> logging.Logger:
    logger = logging.getLogger(filename)
    logger.propagate = False
    logger.setLevel(logging.DEBUG)
    if logger.handlers:
        return logger
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    fmt = logging.Formatter('[%(asctime)s] %(message)s')
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if file_handle:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename, mode='a')
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
