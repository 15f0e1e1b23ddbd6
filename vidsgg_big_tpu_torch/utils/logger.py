"""Logging helper (same contract as the reference's ``create_logger``:
file + stream handlers, reference utils/utils_func.py:209-221)."""
from __future__ import annotations

import logging
import os


def create_logger(filename: str = "train.log", filemode: str = "a",
                  fmt: str = "%(asctime)s - %(message)s",
                  level=logging.DEBUG) -> logging.Logger:
    logger = logging.getLogger(os.path.abspath(filename))
    logger.setLevel(level)
    logger.handlers.clear()
    formatter = logging.Formatter(fmt)
    fh = logging.FileHandler(filename, mode=filemode)
    fh.setFormatter(formatter)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
