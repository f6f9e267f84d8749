"""The device's time between steps (the marks' ``gap``: the host's turn
between replays and between calls) over all its marked time, over the
plain calls (``benchmark.marked``), with no profiler running, %: the
untraced counterpart of ``device_idle_pct``."""

from ..marked import totals


def read(run):
    t = totals(run)
    if t is None:
        return None
    return 100.0 * t["layer_s"]["gap"] / sum(t["layer_s"].values())
