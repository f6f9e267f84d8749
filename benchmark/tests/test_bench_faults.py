"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run but its look for a card, on the CPU at a tiny size,
with the program's entry wrapped to plant each fault a cell can have."""

import pytest

import subzero_tpu_torch.simulation as psim
from benchmark import run
from benchmark.faults import FAULTS
from benchmark.tests import tiny


def _broken(entry, fault):
    real = getattr(psim, entry)

    def call(sim, *a, **kw):
        before = sim.model
        out = real(sim, *a, **kw)
        sim.model = fault(before, sim.model)
        return out

    return call


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("make", [lambda: tiny.scan_cell("run_scan"), tiny.life_cycle_cell],
                         ids=["shear_flow.run_scan", "many_floes.run"])
def test_a_broken_step_is_not_correct(make, fault, monkeypatch):
    cell = make()
    monkeypatch.setattr(psim, cell.entry, _broken(cell.entry, FAULTS[fault]))
    r, numbers, ok, shown, failed = run.run_cell(cell, 2**31 + 3, 3.0, False, "cpu",
                                                 clock=lambda: 0.0)
    assert numbers["calls_compared"] >= 1
    assert not ok, shown
    assert failed >= 1
