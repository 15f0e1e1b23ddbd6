"""Videos whose outputs reached the host in the window, per second of it."""


def read(run):
    if run.kind != "serve":
        return None
    return run.videos / run.window_s
