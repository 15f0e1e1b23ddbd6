"""Seconds from the process's start to the window's start: imports, the
card's start, the kernels loaded (built in a checkout's first run), the
weights and inputs drawn, every shape warmed up."""


def read(run):
    return run.setup_s
