"""The device time a step of integrate, wrap and remove (update_floe.py,
simplification.py) and the step's flag writes, mark 6 less mark 5: the
program's layer marks over the plain calls (``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "integrate")
