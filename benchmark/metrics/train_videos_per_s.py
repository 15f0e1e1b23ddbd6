"""Videos of the train steps completed in the window, per second of it."""


def read(run):
    if run.kind != "train":
        return None
    return run.videos / run.window_s
