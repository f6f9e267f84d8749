"""The port's f32 conservation diagnostics against the JAX package's, step by
step, through the first contact of each gated scenario.

tests/test_f32_drift.py gates the JAX package's f32 drift after 5 000 steps of
head_on and three_floes.  The port's own 5 000-step gate runs on the card
(chip_smoke.py ``f32_drift`` and tests/test_torch_cuda.py): the port's plain
step takes ~15 ms on one CPU worker, ~80 s a scenario.

At dt = 1 no floe touches another in those 5 000 steps: head_on closes a
1e4 m gap at 0.25 m/s (first contact at step ~40 000) and three_floes a
1e3 m gap between the triangle and the shifted square at 0.1 m/s (step
~10 000), so the gate measures free drift.  Here both packages start from
the scenario's f32 state carried rigidly along its own velocities (in f64,
rounded to f32; no force acts before contact) to 30 steps before the first
contact, and run 150 steps through it.  Measured on that start: head_on's
floes first touch at step 31 in both packages; three_floes' at step 34 in
the JAX package and step 71 in the port, a corner grazing an edge whose
overlap area in f32 sits at the force law's min-area gate (ROADMAP C).

Tolerances: up to step 30 the KE and momentum series are equal to the bit
and L within 1e-12 of its largest magnitude (the f64 sums over the floes
may add in another order); over all 150 steps every series lies within 2e-4
of its largest magnitude (measured 2.2e-5 for KE, 2.1e-5 for L, 1.2e-6 for
px; head_on's KE falls by 85% in the contact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.simulation as jsim
import subzero_tpu_torch.simulation as tsim
from subzero_tpu.tools import scenarios as jscen
from subzero_tpu_torch import convert
from subzero_tpu_torch.tools import scenarios as tscen

BEFORE = 30
STEPS = 150
# seconds from the scenario's start to 30 steps before the first contact
CARRY = {"head_on": 39970.0, "three_floes": 9970.0}
TOL = 2e-4


def _built(monkeypatch, run_module, scenarios, *args, **kw):
    """The Simulation that ``conservation_run`` builds, taken before it
    runs (its run_scan is swapped for one that returns at once)."""
    got = {}
    ones = torch.ones(1) if run_module is tsim else jnp.ones(1)

    def stub(sim, n_steps, collect=None):
        got["sim"] = sim
        return sim, {"ke": ones}

    with monkeypatch.context() as m:
        m.setattr(run_module, "run_scan", stub)
        scenarios.conservation_run(*args, **kw)
    return got["sim"]


@pytest.mark.parametrize("scenario", ["head_on", "three_floes"])
def test_f32_series_match_jax_through_first_contact(scenario, monkeypatch):
    jax_sim = _built(monkeypatch, jsim, jscen, jnp.float32, scenario, STEPS)
    fl = jax_sim.model.floes
    d = CARRY[scenario] * np.stack([np.asarray(fl.u, np.float64),
                                    np.asarray(fl.v, np.float64)], axis=1)
    fl = fl._replace(
        verts=jnp.asarray((np.asarray(fl.verts, np.float64) + d[:, None]).astype(np.float32)),
        centroid=jnp.asarray((np.asarray(fl.centroid, np.float64) + d).astype(np.float32)))
    jax_sim.model = jax_sim.model.replace(floes=fl)
    m = jax_sim.model
    port_sim = _built(monkeypatch, tsim, tscen, torch.float32, scenario, STEPS,
                      device="cpu")
    tfl = convert.from_jax_state(m.floes, m.ocean, m.atmos, m.domain, m.grid,
                                 device="cpu", dtype=torch.float32)[0]
    port_sim.model = port_sim.model.replace(floes=tfl)

    def jax_collect(floes, ocean):
        return {"f": jnp.max(jnp.abs(floes.collision_force)),
                **jscen._f64_diagnostics(floes, ocean)}

    def port_collect(floes, ocean):
        return {"f": torch.max(torch.abs(floes.collision_force)),
                **tscen._f64_diagnostics(floes, ocean)}

    ref = {k: np.asarray(v, np.float64) for k, v in
           jsim.run_scan(jax_sim, STEPS, collect=jax_collect)[-1].items()}
    got = {k: v.numpy().astype(np.float64) for k, v in
           tsim.run_scan(port_sim, STEPS, collect=port_collect)[1].items()}

    # both packages reach contact inside the horizon, not before step 31
    for force in (ref.pop("f"), got.pop("f")):
        assert not force[:BEFORE].any() and force.any()
    for k in ("ke", "px", "py"):
        np.testing.assert_array_equal(got[k][:BEFORE], ref[k][:BEFORE], err_msg=k)
    scale = {k: np.abs(r).max() for k, r in ref.items()}
    np.testing.assert_allclose(got["l"][:BEFORE], ref["l"][:BEFORE], rtol=0,
                               atol=1e-12 * scale["l"])
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=TOL * scale[k], err_msg=k)
