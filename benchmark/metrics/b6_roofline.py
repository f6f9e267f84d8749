"""B6's (the coupling's cell clip's) share of its roofline: the least time
the card could take for a coupled step's launch (``roofline/cell_clip.py``,
from the reference's window mask at the profiled stretch's first and last
states) over the mean device time of the step's own launches (its trace
events that a graph replay launched), %.  None where no launch of B6 is in
the trace (a program without the kernel)."""

from ..roofline import cell_clip


def read(run):
    if run.profile is None or "cell_clip" not in run.roofline:
        return None
    times = [d for name, ds in run.profile["by_kernel_graph"].items()
             if cell_clip.EVENT in name for d in ds]
    if not times:
        return None
    return 100.0 * run.roofline["cell_clip"]["bound_s"] / (sum(times) / len(times))
