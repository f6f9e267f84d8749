"""Slot tests a step of the binned broad phase: each live floe against the
occupied slots of its neighbour bins, counted on the device by the
program's mark 1 (``bin_tests``), over the plain calls that
``benchmark.marked`` keeps.  None where the program counts no bins (the
dense broad phase counts 0; a program without the counter holds none)."""

from ..marked import _near_traced


def read(run):
    if not run.window.records:
        return None
    first = run.window.records[0]
    skip = _near_traced(run) | {(first.pass_no, first.call_no)}
    kept = [r.graph_stats for r in run.plain_calls()
            if (r.pass_no, r.call_no) not in skip
            and r.graph_stats and "bin_tests" in r.graph_stats]
    steps = sum(g["steps_marked"] for g in kept)
    tests = sum(g["bin_tests"] for g in kept)
    if not steps or not tests:
        return None
    return tests / steps
