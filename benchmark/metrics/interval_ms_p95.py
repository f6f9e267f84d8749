"""The 95th percentile of the wall time of every call of the window (one
interval of the cell's ``call_steps`` steps, from the last call's return to
this one's), in ms."""

from ..harness import percentile


def read(run):
    return 1e3 * percentile([r.seconds for r in run.window.records], 95)
