"""The per-layer metrics that read the program's layer marks and counters
(``benchmark/marked.py``) on the tiny cells, on the CPU: each reads a
number, the six layers add up to the plain calls' marked step time, and
the layers with the gap to the calls' wall time a step."""

import pytest

from benchmark import marked, run
from benchmark.tests import tiny

LAYERS = ["broad", "clip", "force", "sums", "couple", "integrate"]
METRICS = [f"{k}_ms_per_step" for k in LAYERS] + [
    "untraced_idle_pct", "pairs_per_step", "slow_rows_per_step"]


@pytest.mark.parametrize("entry", ["run_scan", "run"])
def test_marks_metrics_read_the_calls(entry):
    cell = tiny.scan_cell(entry)
    r, *_ = run.run_cell(cell, 2**31 + 11, 1.0, False, "cpu", clock=lambda: 0.0)
    values = {m: run.load_reader(m)(r) for m in METRICS}
    assert all(isinstance(v, float) for v in values.values()), values
    t = marked.totals(r)
    layers_ms = sum(values[f"{k}_ms_per_step"] for k in LAYERS)
    marked_ms = 1e3 * sum(v for k, v in t["layer_s"].items() if k != "gap") / t["steps"]
    assert layers_ms == pytest.approx(marked_ms, rel=0.1)
    # the window's first call is left out: its first gap reaches into set-up
    kept = r.window.records[1:]
    wall_ms = 1e3 * sum(c.seconds for c in kept) / sum(c.steps for c in kept)
    assert layers_ms / (1 - values["untraced_idle_pct"] / 100) == pytest.approx(
        wall_ms, rel=0.1)
    assert values["pairs_per_step"] > 0 and values["slow_rows_per_step"] >= 0


def test_marks_metrics_read_nothing_from_a_program_without_marks():
    cell = tiny.scan_cell("run_scan")
    r, *_ = run.run_cell(cell, 2**31 + 13, 0.5, False, "cpu", clock=lambda: 0.0)
    for rec in r.window.records:
        rec.graph_stats = {k: v for k, v in rec.graph_stats.items()
                           if k not in ("layer_s", "steps_marked", "pairs", "slow_rows")}
    assert all(run.load_reader(m)(r) is None for m in METRICS)
