"""The device time a step of the force law (the slow rows' sides, the overlap
marking, both collisions._region_forces), mark 3 less mark 2: the program's
layer marks over the plain calls (``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "force")
