"""A pass run in 10-step calls (the window's way) ends in the same state as
one call over the whole pass, bitwise, generator included: the window's
calls are the program's "run in parts" path, not another program."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs import make_inputs
from benchmark.tests import tiny


def _same(a, b):
    for part in ("floes", "ocean"):
        for name, x, y in zip(getattr(a, part)._fields, getattr(a, part), getattr(b, part)):
            assert torch.equal(x, y), f"{part}.{name} differs"


@pytest.mark.parametrize("make", [lambda: tiny.scan_cell("run_scan"),
                                  lambda: tiny.scan_cell("run"), tiny.life_cycle_cell],
                         ids=["shear_flow.run_scan", "shear_flow.run", "many_floes.run"])
def test_pass_in_parts_equals_one_call(make):
    cell = make()
    port = harness.port_package()
    inp = make_inputs(cell.cfg, 2**31 + 17)
    whole = harness.build_program(cell, inp, "cpu")
    parts = harness.build_program(cell, inp, "cpu")
    n = cell.cfg["n_dt"]
    if cell.entry == "run_scan":
        port.simulation.run_scan(whole, n)
    else:
        whole.n_dt = n - 1
        port.simulation.run(whole)
    driver = harness.Driver(parts, cell, port.simulation)
    driver.restore()
    for k in range(cell.calls_per_pass):
        driver.call(k)
    _same(whole.model, parts.model)
    if cell.entry == "run":
        assert parts.rng_state == whole.run_stats["rng_state"]
        assert parts.run_stats["max_floe_id"] == whole.run_stats["max_floe_id"]
    # the calls went on from the initial state, which they never wrote
    assert driver.initial is not parts.model
    assert not np.array_equal(driver.initial.floes.centroid.numpy(),
                              parts.model.floes.centroid.numpy())
