"""B1's (the narrow phase's) share of its roofline: the least time the card
could take for the step's launch (``roofline/two_cross.py``, from the
step's batch at the profiled stretch's first and last states) over the mean
device time of the step's own launches (its trace events that a graph
replay launched; a host pass's queries, on other batches, are left out), %."""

from ..roofline import two_cross


def read(run):
    if run.profile is None or "two_cross" not in run.roofline:
        return None
    times = [d for name, ds in run.profile["by_kernel_graph"].items()
             if two_cross.EVENT in name for d in ds]
    if not times:
        return None
    return 100.0 * run.roofline["two_cross"]["bound_s"] / (sum(times) / len(times))
