"""The whole train step's share of the card's peak (``counts/peaks.py``): the
frozen FLOPs of one step (``counts/<config>.py``) over the measured
window's seconds a step."""
from benchmark.metrics._readers import mfu


def read(run):
    return mfu(run, "train")
