"""The device time a step of the contact sums (both
collisions._accumulate_contacts, stress, the fuse marks, the walls' update),
mark 4 less mark 3: the program's layer marks over the plain calls
(``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "sums")
