"""The port's coupling, integration, periodic wrap and removal against the
JAX reference, on a Voronoi floe field over non-uniform ocean/atmosphere
fields, periodic and closed.

The reference's step interpolates one-way fields from per-floe node
windows; the port interpolates the same values with the generic bilinear
gathers (asserted equal by tests/test_coupling_golden.py) and keeps the
same window coverage flag.  f64, rtol 1e-9 (absolute floor 1e-9 of each
field's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.constants import Constants
from subzero_tpu.core import (
    BoundaryKind,
    initialize_floe_field,
    make_atmos,
    make_domain,
    make_grid,
    make_ocean,
)
from subzero_tpu.physics import coupling as jcpl
from subzero_tpu.physics import simplification as jsimp
from subzero_tpu.physics import update_floe as jupd
from subzero_tpu.settings import FloeSettings, SubGridPointsGenerator
from subzero_tpu_torch.physics import coupling as tcpl
from subzero_tpu_torch.physics import simplification as tsimp
from subzero_tpu_torch.physics import update_floe as tupd

from torch_port_helpers import (
    assert_fields_close,
    assert_ocean_close,
    port_settings,
    port_state,
)

GRID = make_grid(-1e5, 1e5, -1e5, 1e5, dx=1e4, dy=1e4)
CONSTS = Constants(E=2e7)
FS = FloeSettings(
    min_floe_area=1e6,
    subfloe_point_generator=SubGridPointsGenerator.from_grid(GRID, 2),
)
DT = 10.0
# the port takes its own settings classes, built from the same field values
TCONSTS = port_settings(CONSTS)
TFS = port_settings(FS)


def _state(periodic, seed=11):
    kind = BoundaryKind.PERIODIC if periodic else BoundaryKind.COLLISION
    domain = make_domain(GRID, kind, kind, kind, kind, dtype=jnp.float64)
    floes = initialize_floe_field(
        30, [0.7], domain, 0.25, 0.05, FS, rng=np.random.default_rng(seed),
        dtype=jnp.float64,
    )
    rng = np.random.default_rng(seed + 1)
    N = floes.capacity
    floes = floes._replace(
        u=jnp.asarray(rng.uniform(-0.2, 0.2, N)),
        v=jnp.asarray(rng.uniform(-0.2, 0.2, N)),
        xi=jnp.asarray(rng.uniform(-2e-6, 2e-6, N)),
        alpha=jnp.asarray(rng.uniform(-0.5, 0.5, N)),
    )
    gx = np.linspace(0, 2 * np.pi, GRID.Nx + 1)
    gy = np.linspace(0, 2 * np.pi, GRID.Ny + 1)
    uo = np.sin(gx)[:, None] * np.cos(gy)[None, :] + 0.3
    vo = np.cos(2 * gx)[:, None] * np.sin(gy)[None, :]
    ocean = make_ocean(GRID, u=uo, v=vo, temp=-1.0, dtype=jnp.float64)
    atmos = make_atmos(GRID, u=3.0 * vo, v=2.0 * uo, temp=-20.0, dtype=jnp.float64)
    return floes, ocean, atmos, domain


def _cell_cap(floes):
    rmax = float(jnp.max(floes.rmax))
    return int(2 * np.ceil(1.5 * rmax / min(GRID.dx, GRID.dy)) + 3)


_jax_one_way = jax.jit(jcpl.calc_one_way_coupling,
                       static_argnames=("grid", "consts", "window"))
_jax_two_way = jax.jit(jcpl.calc_two_way_coupling,
                       static_argnames=("grid", "consts", "floe_settings", "dt",
                                        "cell_cap"))


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "closed"])
def test_one_way_coupling(periodic):
    floes, ocean, atmos, domain = _state(periodic)
    W = _cell_cap(floes) + 1
    ref = _jax_one_way(floes, grid=GRID, domain=domain, ocean=ocean, atmos=atmos,
                       consts=CONSTS, window=W)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, GRID)
    got = tcpl.calc_one_way_coupling(tfl, tgrid, tdom, toc, tat, TCONSTS, window=W)
    assert_fields_close(got.floes, ref.floes, what="floes.")
    assert not bool(ref.window_ovf)
    mask = np.asarray(ref.pt_mask)
    np.testing.assert_array_equal(got.pt_mask.numpy(), mask)
    for f in ("pt_x", "pt_y", "pt_tau_x_ocn", "pt_tau_y_ocn", "pt_cell"):
        g, r = getattr(got, f).numpy()[mask], np.asarray(getattr(ref, f))[mask]
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9 * np.abs(r).max(),
                                   err_msg=f)
    assert bool(got.window_ovf) == bool(ref.window_ovf)


def test_one_way_window_overflow():
    floes, ocean, atmos, domain = _state(True)
    ref = _jax_one_way(floes, grid=GRID, domain=domain, ocean=ocean, atmos=atmos,
                       consts=CONSTS, window=3)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, GRID)
    got = tcpl.calc_one_way_coupling(tfl, tgrid, tdom, toc, tat, TCONSTS, window=3)
    assert bool(ref.window_ovf) and bool(got.window_ovf)


@pytest.mark.parametrize(
    "periodic,small_window", [(True, False), (False, False), (True, True)],
    ids=["periodic", "closed", "window_overflow"],
)
def test_two_way_coupling(periodic, small_window):
    floes, ocean, atmos, domain = _state(periodic)
    cell_cap = 3 if small_window else _cell_cap(floes)
    ow = _jax_one_way(floes, grid=GRID, domain=domain, ocean=ocean, atmos=atmos,
                      consts=CONSTS)
    ref_ocean, ref_ovf = _jax_two_way(ow, grid=GRID, domain=domain, ocean=ocean,
                                      atmos=atmos, consts=CONSTS,
                                      floe_settings=FS, dt=DT, cell_cap=cell_cap)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, GRID)
    tow = tcpl.calc_one_way_coupling(tfl, tgrid, tdom, toc, tat, TCONSTS)
    got_ocean, got_ovf = tcpl.calc_two_way_coupling(
        tow, tgrid, tdom, toc, tat, TCONSTS, TFS, DT, cell_cap
    )
    assert_ocean_close(got_ocean, ref_ocean)
    assert bool(got_ovf) == bool(ref_ovf) == small_window
    assert float(np.max(np.asarray(ref_ocean.si_frac))) > 0


def _forced_state(periodic):
    """Floes carrying collision and ocean forces, some above the clamps."""
    floes, ocean, atmos, domain = _state(periodic)
    rng = np.random.default_rng(5)
    N = floes.capacity
    m = np.asarray(floes.mass)
    big = rng.random(N) < 0.3  # forces past mass / (5 dt): the reduction loop
    cf = rng.normal(size=(N, 2)) * m[:, None] * np.where(big, 1.0, 1e-3)[:, None]
    return floes._replace(
        collision_force=jnp.asarray(cf),
        collision_trq=jnp.asarray(rng.normal(size=N) * 1e9),
        fx_oa=jnp.asarray(rng.normal(size=N) * m * 1e-4),
        fy_oa=jnp.asarray(rng.normal(size=N) * m * 1e-4),
        trq_oa=jnp.asarray(rng.normal(size=N) * 1e8),
        hflx_factor=jnp.asarray(rng.uniform(-1e-3, 1e-3, N)),
        p_dudt=jnp.asarray(rng.normal(size=N) * 1e-4),
        p_dxdt=jnp.asarray(rng.normal(size=N) * 0.1),
    ), ocean, atmos, domain


def test_timestep_floe_properties():
    floes, ocean, atmos, domain = _forced_state(True)
    si = jnp.asarray(np.random.default_rng(9).normal(size=(floes.capacity, 2, 2)) * 1e3)
    ref = jupd.timestep_floe_properties(floes, DT, FS, si)
    tfl, *_ = port_state(floes, domain, ocean, atmos, GRID)
    got = tupd.timestep_floe_properties(tfl, DT, TFS, torch.from_numpy(np.array(si)))
    assert_fields_close(got, ref)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "closed"])
def test_wrap_periodic(periodic):
    floes, ocean, atmos, domain = _state(periodic)
    # push a few floes across the seams
    shift = np.zeros((floes.capacity, 2))
    shift[:6] = [[1.2e5, 0], [-1.2e5, 0], [0, 1.2e5], [0, -1.2e5], [1.2e5, 1.2e5],
                 [-1.2e5, -1.2e5]]
    floes = floes._replace(
        centroid=floes.centroid + shift, verts=floes.verts + shift[:, None, :]
    )
    ref = jupd.wrap_periodic(floes, domain)
    tfl, _, _, tdom, _ = port_state(floes, domain, ocean, atmos, GRID)
    got = tupd.wrap_periodic(tfl, tdom)
    assert_fields_close(got, ref)


def test_remove_and_dissolve():
    floes, ocean, atmos, domain = _state(True)
    N = floes.capacity
    rng = np.random.default_rng(4)
    remove = rng.random(N) < 0.2
    area = np.asarray(floes.area) * np.where(rng.random(N) < 0.3, 1e-4, 1.0)
    height = np.asarray(floes.height) * np.where(rng.random(N) < 0.1, 0.1, 1.0)
    floes = floes._replace(
        remove=jnp.asarray(remove), area=jnp.asarray(area),
        height=jnp.asarray(height),
        fuse_with=jnp.asarray(np.where(rng.random(N) < 0.3, 1, -1), jnp.int32),
    )
    ref_fl, ref_oc = jsimp.remove_and_dissolve(floes, ocean, GRID, domain, FS)
    tfl, toc, _, tdom, tgrid = port_state(floes, domain, ocean, atmos, GRID)
    got_fl, got_oc = tsimp.remove_and_dissolve(tfl, toc, tgrid, tdom, TFS)
    assert_fields_close(got_fl, ref_fl)
    assert_fields_close(got_oc, ref_oc)
    assert float(np.max(np.asarray(ref_oc.dissolved))) > 0
