"""Logging and metric journaling.

``create_logger`` has the reference's contract (file + stream handlers,
reference utils/utils_func.py:209-221).  ``MetricWriter`` is the JAX
package's TensorBoard-free journal: an append-only ``metrics.jsonl``, one
JSON object per scalar event, values at full float precision.
"""
from __future__ import annotations

import json
import logging
import os
import time


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


def quiet_logger() -> logging.Logger:
    """A logger that writes nothing (the ranks other than 0 of a sharded
    run, where rank 0 logs)."""
    logger = logging.getLogger("vidsgg_big_tpu_torch.quiet")
    logger.handlers = [logging.NullHandler()]
    logger.propagate = False
    return logger


class NullWriter:
    """A :class:`MetricWriter` that writes nothing (ranks other than 0)."""
    path = None

    def add_scalar(self, tag: str, value, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class MetricWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
