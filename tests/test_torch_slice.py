"""The port's slice end to end against the JAX reference: the host floe-field
setup from one seed, and run_scan of a small two-way-coupled periodic
configuration compared step by step through ``collect`` (f64), plus a check
that the port imports no JAX."""

import dataclasses
import os
import subprocess
import sys
import warnings

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
    make_model,
    make_ocean,
)
from subzero_tpu.settings import (
    CollisionSettings,
    CouplingSettings,
    FloeSettings,
    SubGridPointsGenerator,
)
from subzero_tpu.simulation import Simulation as JaxSimulation
from subzero_tpu.simulation import run_scan as jax_run_scan
from subzero_tpu_torch import bench as tbench
from subzero_tpu_torch import core as tcore
from subzero_tpu_torch.core.model import make_model as torch_make_model
from subzero_tpu_torch.simulation import Simulation as TorchSimulation
from subzero_tpu_torch.simulation import build_step
from subzero_tpu_torch.simulation import run_scan as torch_run_scan

from torch_port_helpers import (
    REPO,
    assert_fields_close,
    assert_ocean_close,
    port_state,
    port_settings,
    to_np,
)

GRID = make_grid(0.0, 1.5e5, 0.0, 1.5e5, Nx=15, Ny=15)
FS = FloeSettings(
    min_floe_area=1e6,
    subfloe_point_generator=SubGridPointsGenerator.from_grid(GRID, 2),
)


def _shear_u(grid):
    """bench.build_sim's shear ocean: u rises to 0.5 mid-domain and back."""
    ny = grid.Ny + 1
    half = ny // 2 + 1
    u = np.concatenate([np.linspace(0, 0.5, half), np.linspace(0.5, 0, ny - half)])
    return np.broadcast_to(u[None, :], (grid.Nx + 1, ny))


def test_initialize_floe_field_matches_jax():
    jdom = make_domain(GRID, *([BoundaryKind.PERIODIC] * 4), dtype=jnp.float64)
    ref = initialize_floe_field(40, [0.8], jdom, 0.25, 0.05, FS,
                                rng=np.random.default_rng(3), dtype=jnp.float64)
    tdom = tcore.make_domain(GRID, *([tcore.BoundaryKind.PERIODIC] * 4),
                             dtype=torch.float64, device="cpu")
    got = tcore.initialize_floe_field(40, [0.8], tdom, 0.25, 0.05,
                                      port_settings(FS),
                                      rng=np.random.default_rng(3),
                                      dtype=torch.float64, device="cpu")
    assert int(got.count()) == int(ref.count()) >= 30
    assert_fields_close(got, ref, rtol=1e-12, atol_rel=1e-12)


def _overflow_count(records):
    for r in records:
        msg = str(r.message)
        if "steps exceeded" in msg:
            return int(msg.split()[0])
    return 0


def _index(tree, k):
    return type(tree)(*(np.asarray(x)[k] for x in tree))


def _tendency_atol(ref, dt, atol_rel=1e-9):
    """Absolute floors of the integrator's accelerations and of the
    velocities they step.  p_dudt is (fx_oa + collision force) / mass, and
    the two forces can cancel: each force field is held to ``atol_rel`` of
    its largest magnitude, so the acceleration is held to the sum of those
    floors over the mass, and u (which adds 1.5 dt p_dudt) to 1.5 dt times
    that; likewise v, and xi with the torques over the moment.  The strain
    is xi times the floe's geometry (calc_strain), so it gets xi's floor
    scaled by |strain| / |xi|."""
    def floor(a, b, denom):
        d = np.where(denom > 0, denom, 1.0)
        return atol_rel * (np.abs(a).max() + np.abs(b).max()) / d

    cf = ref.collision_force
    acc = {
        "p_dudt": floor(ref.fx_oa, cf[:, 0], ref.mass),
        "p_dvdt": floor(ref.fy_oa, cf[:, 1], ref.mass),
        "p_dxidt": floor(ref.trq_oa, ref.collision_trq, ref.moment),
    }
    vel = {"u": "p_dudt", "v": "p_dvdt", "xi": "p_dxidt"}
    out = {**acc, **{f: 1.5 * dt * acc[a] for f, a in vel.items()}}
    xi = np.abs(ref.xi)
    per_xi = np.abs(ref.strain).max((1, 2)) / np.where(xi > 0, xi, 1.0)
    out["strain"] = (out["xi"] * per_xi)[:, None, None]
    return out


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_voronoi_neighbours_come_in_argsort_order(ties):
    """The Voronoi tessellation's partial sort hands out every index in
    np.argsort's order, past its first m too, with distinct distances and
    with ties (where it takes the full sort)."""
    from subzero_tpu_torch.core.init import _by_distance

    rng = np.random.default_rng(5)
    d = rng.random(1000)
    if ties:
        d = np.round(d * 50) / 50
    for m in (1, 8, 64, 999, 1000, 2000):
        np.testing.assert_array_equal(np.fromiter(_by_distance(d, m), int),
                                      np.argsort(d))


def test_run_scan_matches_jax_step_by_step():
    """100 steps of run_scan in both packages.

    Every step of the port, started from the reference's state at the step
    before, lands on the reference's next state at rtol 1e-9 (absolute floor
    1e-9 of each field's largest magnitude; the stored accelerations get the
    floors of the forces they sum, _tendency_atol): the step functions agree
    along the whole trajectory.  The two free runs also stay together,
    within 1e-4 of each field's largest magnitude: overlap areas of grazing
    contacts are shoelace sums over coordinates ~1e5 m whose summation
    order differs between the packages (~1e-11 relative in the contact
    forces at step 10), and contact dynamics amplify that about tenfold
    every 15 steps (measured, collision force: 1.2e-8 at step 50, 1.9e-5
    at step 100; xi 9e-6, u 5e-7)."""
    dtype = jnp.float64
    ocean = make_ocean(GRID, u=_shear_u(GRID), v=0.0, temp=0.0, dtype=dtype)
    atmos = make_atmos(GRID, u=0.0, v=0.0, temp=-1.0, dtype=dtype)
    domain = make_domain(GRID, *([BoundaryKind.PERIODIC] * 4), dtype=dtype)
    floes = initialize_floe_field(40, [0.8], domain, 0.25, 0.0, FS,
                                  rng=np.random.default_rng(3), dtype=dtype)
    area = np.asarray(floes.area)[np.asarray(floes.active)]
    consts = Constants(E=float(1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area)))))
    settings = dict(
        consts=consts, dt=20, n_dt=0, floe_settings=FS,
        coupling_settings=CouplingSettings(coupling_on=True, dt=10,
                                           two_way_coupling_on=True),
        collision_settings=CollisionSettings(), bins=None,
    )
    jsim = JaxSimulation(model=make_model(GRID, ocean, atmos, domain, floes), **settings)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, GRID)
    tsim = TorchSimulation(model=torch_make_model(tgrid, toc, tat, tdom, tfl),
                           **{k: port_settings(v) for k, v in settings.items()})
    assert (tsim.pair_cap, tsim.cell_cap) == (jsim.pair_cap, jsim.cell_cap)
    step = build_step(tsim)

    n = 100
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        jsim, (jfl, joc) = jax_run_scan(jsim, n, collect=lambda f, o: (f, o))
    with warnings.catch_warnings(record=True) as trec:
        warnings.simplefilter("always")
        tsim, (tfl_all, _) = torch_run_scan(tsim, n, collect=lambda f, o: (f, o))
    assert tsim.n_overflow == _overflow_count(trec) == _overflow_count(jrec)
    assert float(np.abs(np.asarray(jfl.collision_force)).max()) > 0  # contacts

    # one step at a time from the reference's states
    for k in range(n - 1):
        f_k, o_k, _, _, _ = port_state(_index(jfl, k), domain, _index(joc, k),
                                       atmos, GRID)
        f1, o1, _, _ = step(f_k, o_k, tdom, k + 1)
        ref = _index(jfl, k + 1)
        assert_fields_close(f1, ref, what=f"step {k + 1} floes.",
                            atol=_tendency_atol(ref, settings["dt"]))
        assert_ocean_close(o1, _index(joc, k + 1), what=f"step {k + 1} ocean.")

    # the free runs
    errs = {}
    for f in ("centroid", "u", "v", "xi", "collision_force", "overarea", "height"):
        g = to_np(getattr(tfl_all, f)).reshape(n, -1)
        r = np.asarray(getattr(jfl, f)).reshape(n, -1)
        errs[f] = np.abs(g - r).max(1) / (np.abs(r).max(1) + 1e-300)
    for f, err in errs.items():
        assert err.max() < 1e-4, (f, int(err.argmax()), float(err.max()))
    for f in ("active", "remove", "fuse_with", "nverts"):
        np.testing.assert_array_equal(to_np(getattr(tfl_all, f)),
                                      np.asarray(getattr(jfl, f)), err_msg=f)


def _jax_bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    return bench


def test_chip_smoke_config_mirrors_bench():
    """subzero_tpu_torch.bench.build_sim, the port's bench setup (chip_smoke
    builds its shear_flow / many_floes fields with it), builds what
    bench.build_sim builds from the same arguments: the same f32 floe pool,
    fields, modulus, settings and capacities (at 40 floes)."""
    bench = _jax_bench()
    ref = bench.build_sim(40, 1e5, 2e3)
    got = tbench.build_sim(40, 1e5, 2e3, device="cpu", dtype=torch.float32)
    assert_fields_close(got.model.floes, ref.model.floes, rtol=0, atol_rel=0)
    assert_fields_close(got.model.ocean, ref.model.ocean, rtol=0, atol_rel=0)
    assert_fields_close(got.model.atmos, ref.model.atmos, rtol=0, atol_rel=0)
    # the port's own classes, equal to the JAX package's field by field
    assert got.consts == port_settings(ref.consts)
    for f in ("dt", "n_dt", "floe_settings", "coupling_settings",
              "collision_settings", "pair_cap", "cell_cap", "clip_cap", "bins"):
        assert getattr(got, f) == port_settings(getattr(ref, f)), f
    # and with the binned broad phase: the same bins and list capacity
    ref = bench.build_sim(400, 1e5, 2e3, bins=True)
    got = tbench.build_sim(400, 1e5, 2e3, device="cpu", dtype=torch.float32,
                           bins=True)
    assert got.bins == ref.bins and got.bins is not None
    assert got.pair_cap == ref.pair_cap == 8 * ref.model.floes.capacity


def test_bench_measure_on_the_cpu():
    """subzero_tpu_torch.bench.measure on a 40-floe field on the CPU: every
    key of bench.py's measure and the port's own, the JAX package's
    candidate pair count, and a finite end state with no floe lost."""
    import jax

    from subzero_tpu.physics.collisions import find_candidate_pairs

    ref = _jax_bench().build_sim(40, 1e5, 2e3)
    jpairs = jax.jit(find_candidate_pairs, static_argnums=(2, 3))(
        ref.model.floes, ref.model.domain, ref.pair_cap, ref.bins)
    sim = tbench.build_sim(40, 1e5, 2e3, device="cpu")
    r = tbench.measure(sim, n_steps=3)
    assert set(r) == {"pairs_per_s", "steps_per_s", "step_ms", "pairs_per_step",
                      "n_floes", "binned", "two_way_coupling", "n_steps",
                      "n_overflow", "finite", "n_floes_end", "peak_mem_gib"}
    assert r["pairs_per_step"] == int(jnp.sum(jpairs.valid)) > 0
    assert r["n_floes"] == r["n_floes_end"] == int(ref.model.floes.count())
    assert r["finite"] and r["n_overflow"] == 0 and r["peak_mem_gib"] is None
    assert not r["binned"] and r["two_way_coupling"] and r["n_steps"] == 3
    assert r["pairs_per_s"] == pytest.approx(r["pairs_per_step"] * 1e3 / r["step_ms"],
                                             rel=1e-3)
    line = tbench.result_line({"shear_flow_500": r})
    assert line["value"] == r["pairs_per_s"] and line["unit"] == "pairs/s"
    assert line["vs_baseline"] == round(r["pairs_per_s"] / 1e6, 3)


def test_chip_smoke_many_floes_mirrors_the_example():
    """chip_smoke.build_many_floes, the port's life-cycle setup, builds what
    examples/many_floes.py:build builds from the same floe count: the same
    f32 pool (twice the floes), fields, modulus, every settings object, the
    capacities and the broad phase (at 40 floes).  It differs in what it
    states: no writers, not verbose, its own name, n_dt and seed."""
    paths = [str(REPO), str(REPO / "examples")]
    sys.path[:0] = paths
    try:
        import chip_smoke
        import many_floes
    finally:
        for p in paths:
            sys.path.remove(p)
    ref = many_floes.build(n_dt=600, n_floes=40)
    got = chip_smoke.build_many_floes(40, device="cpu", dtype=torch.float32, n_dt=600)
    assert got.model.floes.capacity == ref.model.floes.capacity == 80
    assert_fields_close(got.model.floes, ref.model.floes, rtol=0, atol_rel=0)
    assert_fields_close(got.model.ocean, ref.model.ocean, rtol=0, atol_rel=0)
    assert_fields_close(got.model.atmos, ref.model.atmos, rtol=0, atol_rel=0)
    np.testing.assert_array_equal(to_np(got.model.domain.vals),
                                  np.asarray(ref.model.domain.vals))
    assert got.model.domain.kinds == ref.model.domain.kinds
    assert got.consts == port_settings(ref.consts)
    for f in ("dt", "n_dt", "floe_settings", "coupling_settings",
              "collision_settings", "fracture_settings", "simp_settings",
              "ridgeraft_settings", "weld_settings", "interleave_ridge_raft",
              "pair_cap", "cell_cap", "clip_cap", "bins"):
        assert getattr(got, f) == port_settings(getattr(ref, f)), f
    assert got.writers is None and ref.writers is None
    # the two settings the card-against-CPU phase changes, and nothing else
    weak = chip_smoke.build_many_floes(40, device="cpu", dtype=torch.float32,
                                       n_dt=600, deform=True, pstar=200.0)
    assert weak.fracture_settings == dataclasses.replace(
        got.fracture_settings, deform_on=True,
        criteria=dataclasses.replace(got.fracture_settings.criteria, pstar=200.0))
    assert all(getattr(weak, f) == getattr(got, f) for f in
               ("floe_settings", "ridgeraft_settings", "weld_settings", "pair_cap", "bins"))


def test_port_imports_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import subzero_tpu_torch, subzero_tpu_torch.simulation, "
        "subzero_tpu_torch.convert, subzero_tpu_torch.geometry.two_cross\n"
        "import subzero_tpu_torch.core.init\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
