"""``run`` of the port against ``run`` of the JAX package, every life-cycle
process on (the configuration of tests/test_full_pipeline.py: 24 floes in a
pool of 512, fracture, ridge/raft, welding, smoothing, fusing, 60 steps,
f64), from the same numpy-seeded pool and the same generator seed.

``pair_cap`` is 16 * 512 instead of that test's 64 * 512: on the CPU the
port's plain narrow phase computes every row of the fixed-shape candidate
list, and no step of this run overflows the smaller list.

The 60 steps are compared in three legs, steps 0-29, 30-44 and 45-59.  The
JAX package runs them in one go; the port starts each leg from the JAX
package's state and generator state at the leg's first step (a stub writer
records them).  Why: a floe that has never been in contact has stress
exactly zero, and (0, 0) is the tip of the Hibler yield ellipse, whose
vertex there is roundoff (~1e-26, from the mean floe height).  Whether such
a floe fractures is decided by the last bits of the mean height, which
differ between the packages once a ridging pass has moved volume by an
overlap area that differs at 1e-9.  (Seen at step 30: floe id 4, principal
stresses [0, 0], fractures in one package and not in the other when both
run free.)  Each leg holds at most one fracture pass after its start.

Tolerances: ids, the active set, vertex counts and every other integer or
boolean field are equal at the end of every leg; continuous fields agree
within 1e-4 of each field's largest magnitude, the bound
tests/test_torch_slice.py holds its free runs to (summation order differs
between the packages and contact dynamics amplify it); the generator states
are equal at every writer call and at the end of every leg."""

import copy
import types
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
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    RidgeRaftSettings,
    SimplificationSettings,
    SubGridPointsGenerator,
    WeldSettings,
)
from subzero_tpu.simulation import Simulation as JaxSimulation
from subzero_tpu.simulation import _auto_bins as jax_auto_bins
from subzero_tpu.simulation import run as jax_run
from subzero_tpu_torch.core.model import make_model as torch_make_model
from subzero_tpu_torch.simulation import AUTO_BINS_MIN_N
from subzero_tpu_torch.simulation import Simulation as TorchSimulation
from subzero_tpu_torch.simulation import _auto_bins as torch_auto_bins
from subzero_tpu_torch.simulation import run as torch_run

from torch_port_helpers import port_settings, port_state, to_np

FREE_RUN_TOL = 1e-4
N_DT = 60
WRITE_EVERY = 15
LEG_STEPS = {0: 30, 30: 15, 45: 15}   # first step of a leg -> its steps
LEG_STARTS = tuple(LEG_STEPS)


class StubWriters:
    """The duck type ``run`` asks of ``sim.writers``; records every call."""

    def __init__(self):
        self.floes = types.SimpleNamespace(interval=WRITE_EVERY)
        self.grid = None
        self.checkpoint = None
        self.calls = []   # (package of the sim, tstep, generator state)
        self.closed = 0

    def write_data(self, sim, tstep, floes, ocean, domain, rng_state=None):
        pkg = type(sim).__module__.split(".")[0]
        self.calls.append((pkg, int(tstep), rng_state["state"]["state"]))

    def close(self):
        self.closed += 1

    def of(self, pkg):
        return [(t, s) for p, t, s in self.calls if p == pkg]


def _settings(fs, **over):
    kw = dict(
        consts=Constants(E=1e6),
        dt=10,
        n_dt=N_DT,
        seed=5,
        floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=False),
        fracture_settings=FractureSettings(
            fractures_on=True,
            criteria=HiblerYieldCurve(pstar=1e-9, c=20.0),
            dt=15,
            npieces=2,
        ),
        ridgeraft_settings=RidgeRaftSettings(
            ridge_raft_on=True, dt=10,
            ridge_probability=1.0, min_overlap_frac=0.001,
            domain_gain_probability=0.0,
        ),
        weld_settings=WeldSettings(
            weld_on=True, dts=[20], nxs=[2], nys=[2],
            welding_coeff=1000.0, max_weld_area=1e10,
        ),
        simp_settings=SimplificationSettings(
            smooth_vertices_on=True, dt_smooth=25, max_vertices=20
        ),
        pair_cap=64 * 512,
    )
    kw.update(over)
    return kw


def _build(n_floes=24, N=512, field_seed=6, **over):
    """The same pool and settings as a JAX Simulation and a port one."""
    dtype = jnp.float64
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    ocean = make_ocean(grid, u=0.3, v=0.1, temp=0.0, dtype=dtype)
    atmos = make_atmos(grid, temp=-1.0, dtype=dtype)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=dtype)
    fs = FloeSettings(
        min_floe_area=1e6,
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2),
    )
    floes = initialize_floe_field(
        n_floes, [0.6], domain, 0.5, 0.1, fs, rng=np.random.default_rng(field_seed),
        dtype=dtype, N=N,
    )
    kw = _settings(fs, **over)
    jsim = JaxSimulation(model=make_model(grid, ocean, atmos, domain, floes), **kw)
    return jsim, _port_sim(jsim, kw), fs


def _port_sim(jsim, kw, floes=None, ocean=None, domain=None):
    """A port Simulation on the JAX simulation's state (or the given one)."""
    m = jsim.model
    tfl, toc, tat, tdom, tgrid = port_state(
        m.floes if floes is None else floes, m.domain if domain is None else domain,
        m.ocean if ocean is None else ocean, m.atmos, m.grid)
    return TorchSimulation(
        model=torch_make_model(tgrid, toc, tat, tdom, tfl),
        **{k: port_settings(v) for k, v in kw.items()},
    )


def _small(**over):
    """A pool of 128 with a list of 32 rows a floe: the quick configuration
    of the port-only tests."""
    return _build(24, 128, 6, pair_cap=32 * 128, **over)


def _collect(f, o):
    return (f.active.sum(), f.mass.sum())


@pytest.fixture(scope="module")
def legs():
    """The JAX run of 60 steps, and the port's three legs beside it."""
    jsim, tsim, fs = _build(pair_cap=16 * 512)
    kw = _settings(fs, pair_cap=16 * 512)
    jw, tw = StubWriters(), StubWriters()
    jw.states = {}

    def write_data(sim, tstep, floes, ocean, domain, rng_state=None):
        StubWriters.write_data(jw, sim, tstep, floes, ocean, domain, rng_state)
        jw.states[int(tstep)] = (floes, ocean, domain, copy.deepcopy(rng_state))

    jw.write_data = write_data
    jsim.writers = jw
    mass0 = float(to_np(tsim.model.floes.mass)[to_np(tsim.model.floes.active)].sum())
    id0 = int(to_np(tsim.model.floes.id).max())
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim, jcol = jax_run(jsim, collect=_collect)
        for start in LEG_STARTS:
            jfl, joc, jdom, rng_state = jw.states[start]
            leg = _port_sim(jsim, kw, jfl, joc, jdom)
            leg.writers = tw
            leg.rng_state = copy.deepcopy(rng_state)
            leg.n_dt = LEG_STEPS[start] - 1
            leg, tcol = torch_run(leg, start_tstep=start, collect=_collect)
            out.append((start, leg, tcol))
    return types.SimpleNamespace(
        jsim=jsim, jcol=jcol, jw=jw, tw=tw, legs=out, fs=fs, mass0=mass0, id0=id0)


def _leg_ends(legs):
    """(port leg, the JAX state and generator state the leg should end on)."""
    for start, leg, _ in legs.legs:
        jfl, joc, _, rng_state = legs.jw.states[start + LEG_STEPS[start]]
        yield start, leg, jfl, joc, rng_state


def test_run_same_ids_active_set_and_vertex_counts(legs):
    assert int(np.asarray(legs.jsim.model.floes.id).max()) > legs.id0
    for start, leg, jf, _, _ in _leg_ends(legs):
        tf = leg.model.floes
        assert int(to_np(tf.id).max()) > legs.id0  # topology changed
        for f in jf._fields:
            r = np.asarray(getattr(jf, f))
            if not np.issubdtype(r.dtype, np.floating):
                np.testing.assert_array_equal(to_np(getattr(tf, f)), r,
                                              err_msg=f"leg {start}: {f}")


def test_run_continuous_fields_within_free_run_tolerance(legs):
    for start, leg, jf, jo, _ in _leg_ends(legs):
        tf = leg.model.floes
        act = np.asarray(jf.active)
        for f in jf._fields:
            r = np.asarray(getattr(jf, f))
            if np.issubdtype(r.dtype, np.floating) and r[act].size:
                g = to_np(getattr(tf, f))
                scale = np.abs(r[act]).max()
                err = np.abs(g[act] - r[act]).max()
                assert err <= FREE_RUN_TOL * scale + 1e-300, (start, f, err, scale)
        np.testing.assert_allclose(to_np(leg.model.ocean.dissolved),
                                   np.asarray(jo.dissolved), rtol=FREE_RUN_TOL)


def test_run_generator_state_matches_at_the_end_of_every_leg(legs):
    for start, leg, _, _, rng_state in _leg_ends(legs):
        assert leg.run_stats["rng_state"] == rng_state, start
    states = [s for _, s in legs.jw.of("subzero_tpu")]
    assert len(set(states)) > 1  # the passes drew from the generator


def test_run_mass_ledger_closes(legs):
    _, last, _ = legs.legs[-1]
    out = last.model.floes
    act = to_np(out.active)
    total = float(to_np(out.mass)[act].sum()) + float(
        to_np(last.model.ocean.dissolved).sum())
    assert total <= legs.mass0 * (1 + 1e-9)
    np.testing.assert_allclose(total, legs.mass0, rtol=5e-3)
    h = to_np(out.height)[act]
    assert (h >= legs.fs.min_floe_height - 1e-12).all()
    assert (h <= legs.fs.max_floe_height + 1e-12).all()
    for k in ("centroid", "u", "v", "xi", "mass", "area"):
        assert np.isfinite(to_np(getattr(out, k))[act]).all(), k


def test_run_writer_calls_match(legs):
    """``run`` calls ``write_data`` before every step that is a host event
    (the writer's own interval, or a life-cycle cadence).  The stub sees the
    same time steps, each with the same generator state, from both packages
    (the JAX run also writes at step 60, where no port leg begins), and is
    closed at the end of every run."""
    cadences = (WRITE_EVERY, 10, 15, 20, 25)  # writer, ridge, fracture, weld, smooth
    want = [t for t in range(N_DT + 1) if any(t % c == 0 for c in cadences)]
    assert [t for t, _ in legs.jw.of("subzero_tpu")] == want
    assert legs.tw.of("subzero_tpu_torch") == legs.jw.of("subzero_tpu")[:-1]
    assert (legs.jw.closed, legs.tw.closed) == (1, len(LEG_STARTS))


def test_run_collect_has_one_entry_per_step(legs):
    jn, jm = (np.asarray(x) for x in legs.jcol)
    assert jn.shape == jm.shape == (N_DT + 1,)
    for start, _, tcol in legs.legs:
        k = LEG_STEPS[start]
        assert len(tcol) == 2 and tuple(tcol[0].shape) == (k,)
        np.testing.assert_array_equal(to_np(tcol[0]), jn[start:start + k])
        np.testing.assert_allclose(to_np(tcol[1]), jm[start:start + k], rtol=1e-9)


def test_run_stats_report_segments_passes_and_reads(legs):
    _, first, _ = legs.legs[0]
    st = first.run_stats
    assert st["steps"] == 30
    # steps 0-29: ridge/raft at 10 and 20, fracture at 15, weld at 20,
    # smoothing at 25 (a pass that finds no floe over max_vertices still ran)
    assert st["host_pass_count"]["ridge_raft"] == 2
    assert st["host_pass_count"]["fracture"] == 1
    assert st["host_pass_count"]["weld"] == 1
    assert st["host_pass_count"]["smooth"] == 1
    assert 1 <= st["segments"] <= st["steps"]
    # the plain narrow phase served every pass: no kernel launch to count
    for by_pass in st["host_pass_launches"].values():
        assert set(by_pass) == set(st["host_pass_count"])
        assert not any(by_pass.values())
    assert sum(st["host_pass_seconds"].values()) <= st["seconds"]
    assert all(leg.n_overflow == 0 for _, leg, _ in legs.legs)


def test_run_with_callback_gives_the_same_state_as_segments():
    """A callback makes every step a host event; the trajectory is the same
    to the bit, and the callback sees every time step once."""
    _, a, _ = _small(n_dt=30)
    _, b, _ = _small(n_dt=30)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch_run(a)
        b = torch_run(b, callback=lambda t, f, o, d: seen.append(t))
    assert seen == list(range(31))
    assert b.run_stats["segments"] == 0 < a.run_stats["segments"]
    for f, x, y in zip(a.model.floes._fields, a.model.floes, b.model.floes):
        assert torch.equal(x, y), f
    assert a.run_stats["rng_state"] == b.run_stats["rng_state"]


def test_run_resumes_the_generator_from_rng_state():
    """Two runs of 15 steps, the second seeded with the first's generator
    state, equal one run of 31 steps... at the level run promises: the
    second run draws from the restored stream, not from ``seed`` again."""
    _, a, _ = _small(n_dt=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = torch_run(a)
        mid = a.run_stats["rng_state"]
        fresh = np.random.default_rng(a.seed).bit_generator.state
        assert mid != fresh
        a.rng_state = mid
        a.n_dt = 0
        a = torch_run(a, start_tstep=21)
    assert a.run_stats["steps"] == 1
    # no cadence fell on step 21 and nothing fused: the stream did not move
    if not any(a.run_stats["host_pass_count"].values()):
        assert a.run_stats["rng_state"] == mid


def _summary(sim):
    f = sim.model.floes
    a = to_np(f.active)
    m, u, v = to_np(f.mass)[a], to_np(f.u)[a], to_np(f.v)[a]
    return dict(n=int(a.sum()), mass=m.sum(), ke=0.5 * np.sum(m * (u**2 + v**2)),
                px=np.sum(m * u), py=np.sum(m * v))


def test_interleaved_vs_end_of_step_ridge_raft():
    """The two placements of the ridge/raft pass (mid-step as the Julia model
    has it, or with the other passes at the end of the step) agree within
    the bounds tests/test_lifecycle.py holds the JAX package to: total mass
    1e-6, floe count within 2, kinetic energy within 25 %."""
    over = dict(
        consts=Constants(E=1e6, mu=0.0), n_dt=41, seed=7,
        coupling_settings=CouplingSettings(coupling_on=False),
        fracture_settings=FractureSettings(
            fractures_on=True, criteria=HiblerYieldCurve(pstar=1e-8, c=20.0),
            dt=30, npieces=2),
        ridgeraft_settings=RidgeRaftSettings(
            ridge_raft_on=True, dt=20, ridge_probability=1.0,
            min_overlap_frac=1e-4, domain_gain_probability=0.0),
        weld_settings=WeldSettings(), simp_settings=SimplificationSettings(),
        pair_cap=16 * 256,
    )
    outs = []
    for interleave in (True, False):
        _, sim, _ = _build(16, 256, 11, interleave_ridge_raft=interleave, **over)
        fl = sim.model.floes
        sim.model = sim.model.replace(floes=fl._replace(
            u=torch.where(fl.active, 0.2 * torch.cos(fl.id * 1.7), 0.0),
            v=torch.where(fl.active, 0.2 * torch.sin(fl.id * 2.3), 0.0)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim = torch_run(sim)
        assert sim.run_stats["host_pass_count"]["ridge_raft"] == 2
        assert sim.n_overflow == 0
        outs.append(_summary(sim))
    a, b = outs
    np.testing.assert_allclose(a["mass"], b["mass"], rtol=1e-6)
    assert abs(a["n"] - b["n"]) <= 2
    np.testing.assert_allclose(a["ke"], b["ke"], rtol=0.25)


def test_bins_auto_is_the_default_and_picks_what_jax_picks():
    jsim, tsim, _ = _build()
    assert TorchSimulation.__dataclass_fields__["bins"].default == "auto"
    assert AUTO_BINS_MIN_N == 6000
    assert tsim.bins is None and jsim.bins is None  # 24 floes: dense
    assert torch_auto_bins(tsim.model) == jax_auto_bins(jsim.model)
    jsim, tsim, _ = _build(200, 256, 3)
    got = torch_auto_bins(tsim.model)
    assert got == jax_auto_bins(jsim.model) and got is not None


def test_run_with_explicit_bins_matches_dense_run():
    """``Simulation(bins=(nbx, nby, M))`` runs, and a short life-cycle run
    lands where the dense run lands (pair order differs, so within the
    free-run tolerance)."""
    outs = []
    # 200 floes in a pool of 256 (fracture off: no room for the pieces)
    kw = dict(pair_cap=16 * 256, n_dt=12, fracture_settings=FractureSettings())
    _, dense, _ = _build(200, 256, 3, bins=None, **kw)
    auto = torch_auto_bins(dense.model)
    assert auto is not None and auto[0] >= 3 and auto[1] >= 3
    for bins in (None, auto):
        _, sim, _ = _build(200, 256, 3, bins=bins, **kw)
        assert sim.bins == bins
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs.append(torch_run(sim))
    a, b = (s.model.floes for s in outs)
    assert outs[1].n_overflow == 0
    np.testing.assert_array_equal(to_np(a.id), to_np(b.id))
    np.testing.assert_array_equal(to_np(a.nverts), to_np(b.nverts))
    for f in ("centroid", "u", "v", "mass", "height"):
        x, y = to_np(getattr(a, f)), to_np(getattr(b, f))
        assert np.abs(x - y).max() <= FREE_RUN_TOL * np.abs(x).max(), f
