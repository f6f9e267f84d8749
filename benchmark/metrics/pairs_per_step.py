"""Candidate pairs a step: the broad phase's valid rows, counted on the
device by the program's mark 1, over the plain calls
(``benchmark.marked``)."""

from ..marked import count_per_step


def read(run):
    return count_per_step(run, "pairs")
