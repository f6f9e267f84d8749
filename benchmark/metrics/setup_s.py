"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the field's build, the graphs' capture, warm-up."""


def read(run):
    return run.setup_s
