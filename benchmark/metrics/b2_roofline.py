"""B2's (the slow clip's) share of its roofline: the least time the card
could take for the step's launch (``roofline/intersect_regions.py``, from
the reference's slow rows at the profiled stretch's first and last states)
over the mean device time of the step's own launches (its trace events that
a graph replay launched; a host pass's queries, on other batches, are left
out), %."""

from ..roofline import intersect_regions


def read(run):
    if run.profile is None or "intersect_regions" not in run.roofline:
        return None
    times = [d for name, ds in run.profile["by_kernel_graph"].items()
             if intersect_regions.EVENT in name for d in ds]
    if not times:
        return None
    return 100.0 * run.roofline["intersect_regions"]["bound_s"] / (sum(times) / len(times))
