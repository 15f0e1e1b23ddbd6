"""Device kernels a train step executes, counted in the traced window."""
from benchmark.metrics._readers import kernels_per_step


def read(run):
    return kernels_per_step(run, "train")
