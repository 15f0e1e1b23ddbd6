"""Videos of the BIG-C train steps completed in the window, per second of
it: ``train_videos_per_s`` of a step whose pace the host sets (its
launches and the matching on the host), kept apart so that the host's
swing sets this metric's bound and not the device-bound cells'."""
from benchmark.metrics.train_videos_per_s import read  # noqa: F401
