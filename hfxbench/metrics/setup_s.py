"""Seconds from the process's start to the window's opening: building the
weights, the model and the kernels, warming every shape, fitting the
engine's profiler, and a cell's pre-roll."""


def read(run):
    return run.setup_s
