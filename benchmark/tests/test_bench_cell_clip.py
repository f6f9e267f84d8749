"""The metrics of the coupling's cell clip (``window_cells_per_step``,
``b6_roofline``) on the CPU: B6's bytes and operations
(``roofline/cell_clip.py``) counted by hand, the reference's window mask of
a tiny state against the program's own count of the same cells, and both
readers on runs with and without what they read."""

import pytest

from benchmark import harness, run
from benchmark.inputs import make_inputs
from benchmark.reference import simulation as rsim
from benchmark.roofline import cell_clip
from benchmark.tests import tiny

PEAKS = {"bytes_per_s": 1e12, "f32_ops_per_s": 1e12}


def test_cell_clip_counts_by_hand():
    # 3 floes in f32, windows of 2 x 3 cells: floe 0 (4 vertices) keeps 2
    # cells, floe 1 none, floe 2 (5 vertices) 1
    c = cell_clip.counts(N=3, A=2, B=3, elt=4, nverts=[4, 6, 5], kept=[2, 0, 1])
    # a floe: nverts 4, masks 2 + 3, bounds 2 (2 + 3) 4, areas 6 * 4;
    # rings of the floes with a kept cell; the counter 8
    assert c["bytes"] == 3 * (4 + 5 + 40 + 24) + (4 * 8 + 5 * 8) + 8
    assert cell_clip.OPS_PER_EDGE == 98
    assert c["operations"] == 2 * (98 * 4 + 6) + 1 * (98 * 5 + 6)
    assert (c["rows"], c["live_rows"], c["cells"]) == (3, 2, 3)
    b = cell_clip.bound(dict(N=3, A=2, B=3, elt=4, nverts=[4, 6, 5], kept=[2, 0, 1]),
                        PEAKS)
    assert b["bound_by"] == "operations" and b["bound_s"] == pytest.approx(1292e-12)


def test_cell_clip_launch_inputs_equal_the_programs_count():
    cell = tiny.scan_cell("run_scan")
    inp = make_inputs(cell.cfg, 2**31 + 37)
    ref = harness.build_reference(cell, inp, "cpu")
    inputs = cell_clip.launch_inputs(ref.model, ref)
    assert inputs["A"] == inputs["B"] == ref.cell_cap
    prog = harness.build_program(cell, inp, "cpu")
    harness.port_package().simulation.run_scan(prog, 1, start_tstep=10)
    assert int(inputs["kept"].sum()) == prog.run_stats["graph"]["window_cells"] > 0
    assert cell_clip.bound(inputs, PEAKS)["bound_s"] > 0
    rsim.run_scan(ref, 1, start_tstep=10)  # the reference steps on


def test_cell_clip_readers_with_and_without_what_they_read(monkeypatch):
    # the window closes after its seconds and at least three calls, so that
    # the reader has calls past the first however slow the host is
    calls = []
    after = harness.Hooks.after
    monkeypatch.setattr(harness.Hooks, "after",
                        lambda self, p, k: (calls.append(k), after(self, p, k))[1])
    monkeypatch.setattr(harness.Hooks, "done", lambda self: len(calls) >= 3)
    r, *_ = run.run_cell(tiny.scan_cell("run_scan"), 2**31 + 41, 1.0, False, "cpu",
                         clock=lambda: 0.0)
    assert len(r.window.records) >= 3
    v = run.load_reader("window_cells_per_step")(r)
    assert isinstance(v, float) and v > 0
    for rec in r.window.records:
        rec.graph_stats = {k: v for k, v in rec.graph_stats.items() if k != "window_cells"}
    assert run.load_reader("window_cells_per_step")(r) is None
    # an untraced run holds no profile, and a traced one without B6's
    # launch or bound reads nothing either
    assert run.load_reader("b6_roofline")(r) is None
    r.profile = {"by_kernel_graph": {"regions_kernel": [1e-5]}}
    r.roofline = {"cell_clip": {"bound_s": 1e-7}}
    assert run.load_reader("b6_roofline")(r) is None
    r.profile = {"by_kernel_graph": {"void cell_clip_kernel<float>(Args<float>)": [1e-5, 3e-5]}}
    assert run.load_reader("b6_roofline")(r) == pytest.approx(0.5)
