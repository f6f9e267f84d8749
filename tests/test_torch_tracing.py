"""The port's instrumentation (subzero_tpu_torch/tracing.py) on the CPU:

* the StepGraph's layer marks account for a ``run_scan`` and a ``run``
  call: the layers' seconds and ``gap`` add up to the call's wall time, a
  call that holds a coupled step reads the coupling, and every step run
  is marked once;
* the marks' counters equal ``timestep_collisions(..., with_debug=True)``'s
  ``n_candidates`` and ``n_slow`` summed over the same steps taken
  eagerly, on a field with slow rows and a parity retry, and the marked
  steps end in the bits of the same steps without marks;
* a host span makes no ``record_function`` call while no profiler
  records, and the program's spans appear in a profiler session's events
  while one does.
"""

import time

import pytest
import torch

from subzero_tpu_torch import tracing
from subzero_tpu_torch.bench import build_sim
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics.lifecycle_host import HostFloes
from subzero_tpu_torch.simulation import build_step, run, run_scan

from test_torch_step_graph import _packed_sim


def _field():
    return build_sim(40, 4e4, 4e3, device="cpu")


def _call(sim, entry, start, n):
    """One call of ``n`` steps from ``start``; its wall seconds."""
    t = time.perf_counter()
    if entry == "run_scan":
        run_scan(sim, n, start_tstep=start)
    else:
        sim.n_dt = n - 1
        run(sim, start_tstep=start)
    return time.perf_counter() - t


@pytest.mark.parametrize("entry", ["run_scan", "run"])
def test_marks_account_for_a_call(entry):
    sim = _field()
    # steps 1-4 hold no coupled step (its cadence is 10), steps 5-10 one
    plain_wall = _call(sim, entry, 1, 4)
    plain = sim.run_stats["graph"]
    coupled_wall = _call(sim, entry, 5, 6)
    coupled = sim.run_stats["graph"]
    assert plain["steps_marked"] == 4 and coupled["steps_marked"] == 6
    assert set(plain["layer_s"]) == set(tracing.LAYERS)
    for st, wall in ((plain, plain_wall), (coupled, coupled_wall)):
        assert sum(st["layer_s"].values()) == pytest.approx(wall, rel=0.1)
        assert all(v >= 0 for v in st["layer_s"].values())
    assert coupled["layer_s"]["couple"] > 10 * plain["layer_s"]["couple"] / 4
    # the host spans of the call, and the graph's own
    spans = sim.run_stats["spans"]
    assert spans["count"][entry] == 1
    assert spans["count"][f"{entry}.read"] == (6 if entry == "run" else 1)
    assert spans["count"]["step_graph.load"] >= 1
    assert spans["count"]["step_graph.state"] == coupled["spans"]["count"][
        "step_graph.state"] == 1


def test_counters_equal_the_debug_counts_and_marks_change_no_bit():
    sim = _packed_sim("parity_retry")
    m = sim.model
    floes, ocean, domain = m.floes, m.ocean, m.domain
    step = build_step(sim)   # no marks
    n_steps, pairs, slow, slow_max = 3, 0, 0, 0
    for t in range(1, 1 + n_steps):
        _, dbg = tcol.timestep_collisions(
            floes, domain, sim.consts, float(sim.dt), sim.collision_settings,
            sim.pair_cap, sim.clip_cap, sim.bins, with_debug=True)
        pairs += int(dbg["n_candidates"])
        slow += int(dbg["n_slow"])
        slow_max = max(slow_max, int(dbg["n_slow"]))
        floes, ocean, domain, _ = step(floes, ocean, domain, t)
    assert slow > 0
    with pytest.warns(UserWarning, match="exceeded"):
        run_scan(sim, n_steps, start_tstep=1)
    st = sim.run_stats["graph"]
    assert (st["steps_marked"], st["pairs"], st["slow_rows"]) == (n_steps, pairs, slow)
    assert st["slow_rows_max"] == slow_max and st["slow_cap"] == 32
    assert 0 < st["pairs_max"] <= st["pair_rows"]
    for part, want in (("floes", floes), ("ocean", ocean)):
        got = getattr(sim.model, part)
        for name, x, y in zip(got._fields, got, want):
            assert torch.equal(x, y), f"{part}.{name}"


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    acc = tracing.new_spans()
    for _ in range(3):
        with tracing.span("a", acc):
            pass
    assert opened == [] and acc["count"] == {"a": 3} and acc["seconds"]["a"] >= 0


def test_program_spans_appear_in_a_profiler_session():
    sim = _field()
    run_scan(sim, 1, start_tstep=1)   # makes the graph: the next call loads
    sim.n_dt = 0                      # one step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(sim, start_tstep=2)
        HostFloes(sim.model.floes).to_state()
    names = {e.name for e in prof.events()}
    assert {"run", "run.read", "step_graph.load", "step_graph.state",
            "pool.pull", "pool.push"} <= names, names
