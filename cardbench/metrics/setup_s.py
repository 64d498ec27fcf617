"""Seconds from the start of the run's process to the start of the window:
imports, the inputs, the graph's admission (one timed candidate, the
schedule build and upload, a kernel build where none is cached) and the
warm-up."""


def read(run):
    return run.setup_s
