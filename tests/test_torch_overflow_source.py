"""Which capacity fires the overflow flag, in both packages, on one pool.

* ``tests/data/lifecycle_step526_crowded.npz`` is the port's life-cycle run
  (``examples.many_floes``, 1 000 floes in a pool of 2 000, f32, seed 1, as
  ``chip_smoke.py`` ``lifecycle`` runs it on the CPU) at the pre-step state
  of step 526, its first step over capacity, cut to the 108 floes around the
  crowded one (rows renumbered keeping each row's parity and order, which
  decide the broad phase's pair ownership).  Fed to both packages, the
  candidate lists are equal and ``pairs_overflow`` fires on the same floe:
  17 candidates against 8 rows plus 8 spills, and the counters of
  ``timestep_collisions(..., with_debug=True)`` are equal (f32, the run's
  dtype).
* ``tools.probe_overflow_source`` names the crowded floe, and its ``run``
  callback path counts what ``run`` counts.
* ``multihost.Comm`` without ``device`` wants the card.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.constants import Constants as JConstants
from subzero_tpu.core.domain import Domain as JDomain
from subzero_tpu.core.domain import empty_topography as jax_empty_topography
from subzero_tpu.core.floes import FloeState as JFloes
from subzero_tpu.physics import collisions as jcol
from subzero_tpu.settings import CollisionSettings as JCollisionSettings
from subzero_tpu_torch.constants import Constants
from subzero_tpu_torch.core import make_atmos, make_grid, make_model, make_ocean
from subzero_tpu_torch.core.domain import Domain, empty_topography
from subzero_tpu_torch.core.floes import FloeState
from subzero_tpu_torch.parallel import multihost
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.settings import CollisionSettings
from subzero_tpu_torch.simulation import Simulation, run
from subzero_tpu_torch.tools import probe_overflow_source as probe

from test_collisions import OPEN_DOMAIN
from test_torch_collisions import _jax_collide, assert_same_counters
from test_torch_collisions_slow_path import crowded_ring
from torch_port_helpers import port_state

POOL = Path(__file__).parent / "data" / "lifecycle_step526_crowded.npz"
_jax_pairs = jax.jit(jcol.find_candidate_pairs, static_argnums=(2,))


def _pool(dtype):
    """The stored pool in both packages at ``dtype``, and its metadata."""
    z = np.load(POOL)
    meta = json.loads(str(z["meta"]))
    fl = {k[len("floes_"):]: z[k] for k in z.files if k.startswith("floes_")}

    def cast(v):
        return v.astype(dtype) if v.dtype.kind == "f" else v

    kinds = tuple(meta["domain_kinds"])
    vals, vel = cast(z["domain_vals"]), cast(z["domain_velocities"])
    jfl = JFloes(**{k: jnp.asarray(cast(v)) for k, v in fl.items()})
    jdom = JDomain(kinds=kinds, vals=jnp.asarray(vals), velocities=jnp.asarray(vel),
                   topography=jax_empty_topography(dtype=jnp.dtype(dtype)))
    tfl = FloeState(**{k: torch.from_numpy(cast(v)) for k, v in fl.items()})
    tdom = Domain(kinds=kinds, vals=torch.from_numpy(vals), velocities=torch.from_numpy(vel),
                  topography=empty_topography(dtype=tfl.verts.dtype, device="cpu"))
    return (jfl, jdom), (tfl, tdom), meta


def test_life_cycle_pool_overflows_on_the_same_floe_in_both_packages():
    (jfl, jdom), (tfl, tdom), meta = _pool(np.float32)
    pair_cap = meta["pair_cap_rows_a_floe"] * tfl.capacity
    _, jdbg = _jax_collide(jfl, jdom, consts=JConstants(), dt=20.0,
                           collision_settings=JCollisionSettings(), pair_cap=pair_cap,
                           clip_cap=16, with_debug=True)
    _, tdbg = tcol.timestep_collisions(tfl, tdom, Constants(), 20.0, CollisionSettings(),
                                       pair_cap, with_debug=True)
    assert_same_counters(tdbg, jdbg)
    assert bool(tdbg["pairs_overflow"]) and not bool(tdbg["clip_overflow"])
    assert int(tdbg["n_slow"]) <= int(tdbg["slow_cap"])

    jp = _jax_pairs(jfl, jdom, pair_cap)
    tp = tcol.find_candidate_pairs(tfl, tdom, pair_cap)
    for f, j, t in zip(tp._fields, jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)

    # the crowded floe, and every row's candidates with room for all of them
    sim = type("S", (), {"pair_cap": pair_cap, "bins": None})
    crowded = probe.crowded_floe(sim, tfl, tdom)
    N = tfl.capacity
    jfull = _jax_pairs(jfl, jdom, N * (N + 4))
    n = np.bincount(np.asarray(jfull.qi)[np.asarray(jfull.valid)], minlength=N)
    assert crowded["id"] == meta["crowded_floe_id"] == int(np.asarray(jfl.id)[n.argmax()])
    assert crowded["candidates"] == int(n.max()) == 17
    assert crowded["row_cap"] + crowded["d_spill"] == 16
    assert crowded["rows_over_row_cap_plus_spill"] == int((n > 16).sum()) == 1


def test_probe_names_the_crowded_floe_of_a_ring():
    """The ring of tests/test_torch_collisions_slow_path.py: floe 0 owns the
    20 even rows of its 40 neighbours."""
    tfl, _, _, tdom, _ = port_state(crowded_ring(), OPEN_DOMAIN)
    sim = type("S", (), {"pair_cap": 8 * tfl.capacity, "bins": None})
    got = probe.crowded_floe(sim, tfl, tdom)
    assert (got["row"], got["candidates"], got["rows_over_row_cap_plus_spill"]) == (0, 20, 1)
    assert got["candidates_of_all_rows"] >= 40


def _ring_sim():
    jfl = crowded_ring()
    grid = make_grid(-1e5, 1e5, -1e5, 1e5, dx=1e4, dy=1e4)
    tfl, _, _, tdom, _ = port_state(jfl, OPEN_DOMAIN)
    model = make_model(grid, make_ocean(grid, dtype=torch.float64, device="cpu"),
                       make_atmos(grid, dtype=torch.float64, device="cpu"), tdom, tfl)
    return Simulation(model=model, consts=Constants(E=1e6), dt=10, n_dt=3, bins=None)


def test_probe_through_run_counts_what_run_counts():
    """``probe_run`` (the probe as ``run``'s callback) counts the same
    overflow steps as ``run`` without a callback, and every one of them is
    the candidate rows running out; ``probe_steps`` sees the same hits."""
    plain = run(_ring_sim())
    out = []
    got = probe.probe_run(_ring_sim(), out=out.append)
    assert got["n_overflow"] == plain.n_overflow == got["flagged_steps"] == 4
    assert got["hits"] == {"pairs_overflow": 4, "compact_overflow": 0,
                           "clip_overflow": 0, "slow": 0}
    assert got["crowded_floe"]["step"] == 0 and len(out) == 4
    stepped = probe.probe_steps(_ring_sim(), 4, out=None)
    assert stepped["hits"] == got["hits"] and stepped["n_overflow"] == 4


def test_comm_without_device_wants_the_card():
    if torch.cuda.is_available():
        assert multihost.Comm().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.Comm()
    assert multihost.Comm(device="cpu").device == torch.device("cpu")
