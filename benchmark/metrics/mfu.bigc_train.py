"""``mfu.train`` of the BIG-C train cells, which report
``bigc_train_videos_per_s``: the frozen FLOPs of one step over the measured
window's seconds a step, as a share of the card's peak."""
from benchmark.metrics._readers import mfu


def read(run):
    return mfu(run, "train")
