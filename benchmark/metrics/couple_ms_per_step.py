"""The device time a step of the coupling (physics/coupling.py), mark 5 less
mark 4, over every step (a step without it reads about one mark's time): the
program's layer marks over the plain calls (``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "couple")
