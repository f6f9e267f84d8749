"""What the program's layer marks and work counters read, summed over a
run's plain calls, for the per-layer metrics that read them
(``metrics/<layer>_ms_per_step.py``, ``untraced_idle_pct``,
``pairs_per_step``, ``slow_rows_per_step``).

Each call's record holds the program's step-graph counters for that call
(``graph_stats``, the port's ``StepGraph.stats_since``): seconds by layer
(``layer_s``, the device's ``gap`` between steps among them), steps marked,
candidate pairs and slow rows.  A program without marks holds none of them:
every reader then returns None.

A call's first ``gap`` reaches back to the last mark before the call, over
whatever the host did in between.  So the calls whose first gap holds work
that the untraced window does not have are left out: the window's first
call (its gap reaches into the set-up) and, in a traced run, every call of
a traced stretch from its lead to the call after its last (their gaps hold
the profiler's and the sync counter's own host work).
"""

from __future__ import annotations


def _near_traced(run) -> set:
    """(pass, call) of each traced stretch's lead, its calls and the call
    after them."""
    if not run.traced_calls:
        return set()
    out = set(run.traced_calls)
    for spec in run.cell.spec.get("trace", {}).values():
        first = spec["first_call"] - spec.get("lead_calls", 0)
        last = spec["first_call"] + spec["calls"]
        out.update((spec["pass"], k) for k in range(first, last + 1))
    return out


def totals(run):
    """{"steps", "layer_s", "pairs", "slow_rows"} summed over the kept plain
    calls, or None where none holds marks."""
    if not run.window.records:
        return None
    first = run.window.records[0]
    skip = _near_traced(run) | {(first.pass_no, first.call_no)}
    kept = [r.graph_stats for r in run.plain_calls()
            if (r.pass_no, r.call_no) not in skip
            and r.graph_stats and "layer_s" in r.graph_stats]
    steps = sum(g["steps_marked"] for g in kept)
    if not steps:
        return None
    return {"steps": steps,
            "layer_s": {k: sum(g["layer_s"][k] for g in kept) for k in kept[0]["layer_s"]},
            "pairs": sum(g["pairs"] for g in kept),
            "slow_rows": sum(g["slow_rows"] for g in kept)}


def layer_ms_per_step(run, layer: str):
    """One layer's marked device time a step, ms."""
    t = totals(run)
    return None if t is None else 1e3 * t["layer_s"][layer] / t["steps"]


def count_per_step(run, counter: str):
    t = totals(run)
    return None if t is None else t[counter] / t["steps"]
