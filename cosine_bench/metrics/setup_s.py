"""Seconds from the process's start to the window's opening: imports,
kernel builds, weights, the engine, warm-up and the ramp."""


def read(run):
    return run["setup_s"]
