"""Seconds from the process's start to the window's: imports, building
the kernels at first use, rendering and writing the frames, one warm
session."""


def read(run):
    return run.setup_s
