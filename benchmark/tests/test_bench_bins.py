"""The metrics of the binned broad phase and of the slow clip
(``bin_tests_per_step``, ``b2_roofline``) on the CPU: B2's bytes and
operations (``roofline/intersect_regions.py``) on rows counted by hand and
at no slow row, the reference's slow rows of a tiny state, and both readers
on runs with and without what they read."""

import copy

import pytest

import subzero_tpu_torch.simulation as psim
from benchmark import harness, run
from benchmark.inputs import make_inputs
from benchmark.reference import simulation as rsim
from benchmark.roofline import intersect_regions
from benchmark.tests import tiny

PEAKS = {"bytes_per_s": 1e12, "f32_ops_per_s": 1e12}


def test_intersect_regions_counts_by_hand():
    # 4 rows in f32 with CAP 2, two live: P floe 0 with Q slot 1 (retried),
    # P floe 2 with Q slot 1
    c = intersect_regions.counts(rows=4, cap=2, elt=4, live_i=[0, 2], live_j=[1, 1],
                                 p_n=[3, 4, 5], q_n=[4, 4, 6], retried=[True, False])
    # an output row: (1 + 20) floats 84 + 3 * 2 int32 24 + 2 + 2 flags 4 = 112
    assert intersect_regions.row_bytes(2, 4) == 112
    # n_slow 8, each row's selection 8; each live row's qi 8 + qj 8 +
    # perturb 4 + shift 8; rings once each: P 0 (4 + 3 * 8), P 2 (4 + 5 * 8),
    # Q 1 (4 + 4 * 8); 4 output rows and the retried row's first result
    assert c["bytes"] == (8 + 4 * 8 + 2 * 28 + (4 + 24) + (4 + 40) + (4 + 32)
                          + 5 * 112)
    # 30 a crossing test of each edge pair, 40 the ring sums of each vertex,
    # twice on the retried row
    assert c["operations"] == 2 * (30 * 3 * 4 + 40 * 7) + (30 * 5 * 4 + 40 * 9)
    assert (c["rows"], c["live_rows"]) == (4, 2)


def test_intersect_regions_bound_at_no_slow_row():
    inputs = dict(rows=32, cap=16, elt=4, live_i=[], live_j=[], p_n=[4] * 8,
                  q_n=[4] * 12, retried=[])
    b = intersect_regions.bound(inputs, PEAKS)
    assert b["live_rows"] == 0 and b["operations"] == 0 and b["bound_by"] == "bytes"
    assert b["bytes"] == 8 + 32 * (8 + intersect_regions.row_bytes(16, 4))
    assert b["bound_s"] == pytest.approx(b["bytes"] / 1e12)


def test_intersect_regions_launch_inputs_of_a_tiny_state():
    cell = tiny.scan_cell("run_scan")
    ref = harness.build_reference(cell, make_inputs(cell.cfg, 2**31 + 23), "cpu")
    rsim.run_scan(ref, 10)
    inputs = intersect_regions.launch_inputs(ref.model, ref)
    assert inputs["rows"] == max(ref.pair_cap // 128, 32) and inputs["cap"] == ref.clip_cap
    assert len(inputs["live_i"]) == len(inputs["live_j"]) == len(inputs["retried"])
    assert intersect_regions.bound(inputs, PEAKS)["bound_s"] > 0


def _binned_cell():
    """The tiny shear cell on a box that holds enough bins for
    ``_auto_bins``."""
    cell = tiny.scan_cell("run_scan")
    cfg = copy.deepcopy(cell.cfg)
    cfg["domain"]["x"] = cfg["domain"]["y"] = [0.0, 1e5]
    cfg["ocean"]["u"] = {"ends": 0.0, "peak": 0.5, "rise": 26}
    cfg["floes"]["count"] = 300
    return harness.Cell(cell.name, cell.spec, cfg)


def test_bin_tests_reader_on_binned_and_dense_runs(monkeypatch):
    for mod in (psim, rsim):
        monkeypatch.setattr(mod, "AUTO_BINS_MIN_N", 1)
    r, *_ = run.run_cell(_binned_cell(), 2**31 + 29, 3.0, False, "cpu", clock=lambda: 0.0)
    assert r.window.records[0].graph_stats["bin_cap"] > 0
    v = run.load_reader("bin_tests_per_step")(r)
    assert isinstance(v, float) and v > 0
    for mod in (psim, rsim):
        monkeypatch.setattr(mod, "AUTO_BINS_MIN_N", 10**9)
    dense, *_ = run.run_cell(_binned_cell(), 2**31 + 29, 1.0, False, "cpu",
                             clock=lambda: 0.0)
    assert run.load_reader("bin_tests_per_step")(dense) is None


def test_new_readers_read_nothing_from_a_program_without_the_counters():
    r, *_ = run.run_cell(tiny.scan_cell("run_scan"), 2**31 + 31, 0.5, False, "cpu",
                         clock=lambda: 0.0)
    for rec in r.window.records:
        rec.graph_stats = {k: v for k, v in rec.graph_stats.items()
                           if not k.startswith("bin_")}
    assert run.load_reader("bin_tests_per_step")(r) is None
    # an untraced run holds no profile, and a traced one without B2's
    # launch or bound reads nothing either
    assert run.load_reader("b2_roofline")(r) is None
    r.profile = {"by_kernel_graph": {"two_cross_kernel": [1e-5]}}
    r.roofline = {"intersect_regions": {"bound_s": 1e-7}}
    assert run.load_reader("b2_roofline")(r) is None
    r.profile = {"by_kernel_graph": {"void regions_kernel<float, 32, 32>": [1e-5, 3e-5]}}
    assert run.load_reader("b2_roofline")(r) == pytest.approx(0.5)
