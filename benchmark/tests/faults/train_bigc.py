"""Faults of ``drivers/train_bigc.py``."""
from benchmark.tests.faults._training import FAULTS  # noqa: F401
