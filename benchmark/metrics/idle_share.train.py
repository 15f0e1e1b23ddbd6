"""The device's idle share of a train cell's steps: 1 minus the device's busy
seconds a step in the traced pass over the measured window's seconds a
step, in percent."""
from benchmark.metrics._readers import idle_share


def read(run):
    return idle_share(run, "train")
