"""The device time a step of the narrow phase (B1, csrc/two_cross.cu) and the
slow clip (B2, csrc/intersect_regions.cu), mark 2 less mark 1: the program's
layer marks over the plain calls (``benchmark.marked``), ms."""

from ..marked import layer_ms_per_step


def read(run):
    return layer_ms_per_step(run, "clip")
