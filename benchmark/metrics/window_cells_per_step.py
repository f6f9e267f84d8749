"""Window cells clipped a step by the coupling's cell clip: the (floe,
window cell) pairs that the window's mask keeps on each coupled step,
counted on the device by the program's cell clip (``window_cells``), over
the marked steps of the plain calls that ``benchmark.marked`` keeps.  None
where the program holds no such counter."""

from ..marked import _near_traced


def read(run):
    if not run.window.records:
        return None
    first = run.window.records[0]
    skip = _near_traced(run) | {(first.pass_no, first.call_no)}
    kept = [r.graph_stats for r in run.plain_calls()
            if (r.pass_no, r.call_no) not in skip
            and r.graph_stats and "window_cells" in r.graph_stats]
    steps = sum(g["steps_marked"] for g in kept)
    cells = sum(g["window_cells"] for g in kept)
    if not steps or not cells:
        return None
    return cells / steps
