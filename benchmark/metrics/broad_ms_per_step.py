"""The device time a step of the broad phase (open-boundary removal, the
candidate pairs and their sides: collisions.narrow_phase_batch), mark 1 less
mark 0: the program's layer marks over the plain calls
(``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "broad")
