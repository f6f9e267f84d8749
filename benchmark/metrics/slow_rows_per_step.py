"""Slow rows a step: the rows the slow clip (B2) takes (``n_slow``), read on
the device by the program's mark 2, over the plain calls
(``benchmark.marked``)."""

from ..marked import count_per_step


def read(run):
    return count_per_step(run, "slow_rows")
