"""The binned broad phase's work counters (``collisions._bin_counts``, read
by the layer marks, ``tracing.Marks``) on the CPU:

* on a small field with explicit bins, the slot tests and the fullest bin
  equal a numpy count from each step's state (each live floe against the
  occupied slots, at most M a bin, of its neighbour bins), over eager steps
  and over a ``run_scan`` call's StepGraph replays, sums and maxima alike;
* the dense broad phase runs none of the counting and hands mark 1 no bin
  counts, so the counters stay 0 there.
"""

import numpy as np
import pytest
import torch

from subzero_tpu_torch import tracing
from subzero_tpu_torch.bench import build_sim
from subzero_tpu_torch.core.domain import EAST, NORTH, SOUTH, WEST
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.simulation import build_step, run_scan

N_STEPS = 3


def _binned_sim():
    sim = build_sim(300, 1e5, 4e3, device="cpu", bins=True)
    nbx, nby, _ = sim.bins
    assert nbx >= 3 and nby >= 3   # the forward half-shell
    return sim


def _numpy_counts(floes, domain, bins) -> tuple:
    """(slot tests, floes in the fullest bin) of the binned broad phase on a
    state, counted in numpy in the state's dtype."""
    nbx, nby, M = bins
    c = floes.centroid.numpy()
    act = floes.active.numpy()
    vals = domain.vals.numpy()
    bx = (vals[EAST] - vals[WEST]) / vals.dtype.type(nbx)
    by = (vals[NORTH] - vals[SOUTH]) / vals.dtype.type(nby)
    ibx = np.clip(np.floor((c[:, 0] - vals[WEST]) / bx).astype(np.int64), 0, nbx - 1)
    iby = np.clip(np.floor((c[:, 1] - vals[SOUTH]) / by).astype(np.int64), 0, nby - 1)
    counts = np.zeros((nbx, nby), np.int64)
    np.add.at(counts, (ibx[act], iby[act]), 1)
    assert domain.ew_periodic and domain.ns_periodic
    tests = 0
    for i in np.flatnonzero(act):
        for ox, oy in ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 1)):
            tests += min(counts[(ibx[i] + ox) % nbx, (iby[i] + oy) % nby], M)
    return tests, int(counts.max())


def test_bin_counters_equal_a_numpy_count_eager_and_replayed():
    sim = _binned_sim()
    m = sim.model
    floes, ocean, domain = m.floes, m.ocean, m.domain
    step = build_step(sim)   # no marks
    marks = tracing.Marks("cpu")
    want = []
    for t in range(1, 1 + N_STEPS):
        want.append(_numpy_counts(floes, domain, sim.bins))
        tcol.timestep_collisions(floes, domain, sim.consts, float(sim.dt),
                                 sim.collision_settings, sim.pair_cap, sim.clip_cap,
                                 sim.bins, mark=marks)
        pairs = tcol.find_candidate_pairs(floes, domain, sim.pair_cap, sim.bins)
        assert pairs.bin_counts.tolist() == list(want[-1])
        floes, ocean, domain, _ = step(floes, ocean, domain, t)
    tests, fill = (list(x) for x in zip(*want))
    assert min(fill) > 1 and max(fill) <= sim.bins[2]
    eager = marks.stats()
    run_scan(sim, N_STEPS, start_tstep=1)   # the same steps, replayed
    replayed = sim.run_stats["graph"]
    assert replayed["steps_marked"] == N_STEPS
    for st in (eager, replayed):
        assert (st["bin_tests"], st["bin_tests_max"]) == (sum(tests), max(tests))
        assert (st["bin_fill"], st["bin_fill_max"]) == (sum(fill), max(fill))
        assert st["bin_cap"] == sim.bins[2]
    for part, want_state in (("floes", floes), ("ocean", ocean)):
        got = getattr(sim.model, part)
        for name, x, y in zip(got._fields, got, want_state):
            assert torch.equal(x, y), f"{part}.{name}"


def test_dense_broad_phase_counts_no_bins(monkeypatch):
    sim = build_sim(40, 4e4, 4e3, device="cpu")
    assert sim.bins is None

    def not_on_the_dense_path(*a, **kw):
        raise AssertionError("the dense broad phase ran the bins' counters")

    monkeypatch.setattr(tcol, "_bin_counts", not_on_the_dense_path)
    marked = []
    real = tracing.Marks.__call__

    def record(self, k, **kw):
        if k == 1:
            marked.append(kw)
        return real(self, k, **kw)

    monkeypatch.setattr(tracing.Marks, "__call__", record)
    run_scan(sim, N_STEPS, start_tstep=1)
    st = sim.run_stats["graph"]
    assert st["steps_marked"] == N_STEPS and st["pairs"] > 0
    assert len(marked) == N_STEPS and all(kw["bins"] is None for kw in marked)
    for k in ("bin_tests", "bin_fill", "bin_tests_max", "bin_fill_max", "bin_cap"):
        assert st[k] == 0, k
