"""Faults of ``drivers/train_grounding.py``."""
from benchmark.tests.faults._training import FAULTS  # noqa: F401
