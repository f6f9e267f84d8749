"""Simulated seconds per wall second: all the window's steps times dt, over
the window's whole wall time (host passes and pass restarts included)."""


def read(run):
    return run.window.sim_seconds / run.window.seconds
