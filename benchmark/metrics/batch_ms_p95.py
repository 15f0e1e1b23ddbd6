"""The 95th percentile of every request's time in the window, from the step
call until its outputs are on the host (milliseconds)."""
import numpy as np


def read(run):
    if run.kind != "serve" or not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
