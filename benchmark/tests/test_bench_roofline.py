"""B1's bytes and operations (``roofline/two_cross.py``) on a batch counted
by hand."""

import pytest

from benchmark.roofline import two_cross


def test_two_cross_counts_by_hand():
    # 4 rows in f32, two live: P floe 0 with Q slot 1, P floe 2 with Q slot 1
    c = two_cross.counts(rows=4, elt=4, live_i=[0, 2], live_j=[1, 1],
                         p_n=[3, 4, 5], q_n=[4, 4, 6])
    # each row: qi 8 + qj 8 + valid 1 + perturb 4 + shift 8 = 29 read,
    # out 40 + cnt 4 + ok 1 = 45 written; rings read once each:
    # P 0 (4 + 3 * 8), P 2 (4 + 5 * 8), Q 1 (4 + 4 * 8)
    assert c["bytes"] == 4 * 29 + 4 * 45 + (4 + 24) + (4 + 40) + (4 + 32)
    # 30 a crossing test of each edge pair, 3 a shoelace term of each vertex
    assert c["operations"] == (30 * 3 * 4 + 3 * 7) + (30 * 5 * 4 + 3 * 9)
    assert c["live_rows"] == 2


def test_two_cross_bound_names_what_bounds_it():
    inputs = dict(rows=4, elt=4, live_i=[0], live_j=[0], p_n=[32], q_n=[32])
    b = two_cross.bound(inputs, {"bytes_per_s": 1e12, "f32_ops_per_s": 1e12})
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(b["operations"] / 1e12)
