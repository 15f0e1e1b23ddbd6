"""Faults of ``drivers/serve_bigc_bf16.py``: those of ``serve_bigc``."""
from benchmark.tests.faults.serve_bigc import FAULTS  # noqa: F401
