"""Seconds from the start of the run to the start of the window: imports,
tables, the kernels' load (or build) and the warm-up."""


def read(window):
    return window.setup_s
